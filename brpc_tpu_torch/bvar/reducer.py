"""Reducers — counters whose writes touch only the writing thread's cell.

Copy of brpc_tpu/bvar/reducer.py: each writing thread owns a cell, and a
read combines every cell with the reducer's operation. Adder, Maxer and
IntRecorder (an average kept as a (sum, num) pair). Windows difference
the samples of an invertible reducer (Adder, IntRecorder) and combine
those of the others with ``series_op``.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

from brpc_tpu_torch.bvar.variable import Variable


class _Cell:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class Reducer(Variable):
    """``op`` is commutative and associative; ``identity`` its neutral
    value."""

    def __init__(self, op: Callable, identity, name: Optional[str] = None,
                 series_op: Optional[Callable] = None):
        self._op = op
        self._identity = identity
        self._series_op = series_op or op
        self._tls = threading.local()
        self._cells: List[_Cell] = []
        self._cells_lock = threading.Lock()
        super().__init__(name)

    def _cell(self) -> _Cell:
        cell = getattr(self._tls, "cell", None)
        if cell is None:
            cell = _Cell(self._identity)
            self._tls.cell = cell
            with self._cells_lock:
                self._cells.append(cell)
        return cell

    def update(self, value):
        cell = self._cell()
        cell.value = self._op(cell.value, value)

    __lshift__ = update  # brpc idiom: adder << 1

    def get_value(self):
        with self._cells_lock:
            result = self._identity
            for cell in self._cells:
                result = self._op(result, cell.value)
        return result

    @property
    def series_op(self):
        return self._series_op


class Adder(Reducer):
    """Sums; negative updates allowed."""

    invertible = True  # a window's value is now - then

    def __init__(self, name: Optional[str] = None):
        super().__init__(lambda a, b: a + b, 0, name)


class Maxer(Reducer):
    invertible = False

    def __init__(self, name: Optional[str] = None):
        super().__init__(max, float("-inf"), name)

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("-inf") else v


class _Stat:
    __slots__ = ("sum", "num")

    def __init__(self, sum_=0, num=0):
        self.sum = sum_
        self.num = num

    def __add__(self, other):
        return _Stat(self.sum + other.sum, self.num + other.num)

    def __sub__(self, other):
        return _Stat(self.sum - other.sum, self.num - other.num)

    @property
    def average(self) -> float:
        return self.sum / self.num if self.num else 0.0


class IntRecorder(Reducer):
    """The average of the samples: a (sum, num) value whose ``average``
    is read; windows difference it."""

    invertible = True

    def __init__(self, name: Optional[str] = None):
        super().__init__(lambda a, b: a + b, _Stat(), name)

    def update(self, sample: float):
        cell = self._cell()
        cell.value = cell.value + _Stat(sample, 1)

    __lshift__ = update

    def average(self) -> float:
        return self.get_value().average

    def describe(self) -> str:
        s = self.get_value()
        return f"avg={s.average:.3f} num={s.num}"
