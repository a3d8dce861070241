"""Reducers — counters whose writes touch only the writing thread's cell.

Copy of brpc_tpu/bvar/reducer.py's Reducer, Adder and Maxer: each writing
thread owns a cell, and a read combines every cell with the reducer's
operation.
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

    def __init__(self, op: Callable, identity, name: Optional[str] = None):
        self._op = op
        self._identity = identity
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


class Adder(Reducer):
    def __init__(self, name: Optional[str] = None):
        super().__init__(lambda a, b: a + b, 0, name)


class Maxer(Reducer):
    def __init__(self, name: Optional[str] = None):
        super().__init__(max, float("-inf"), name)

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("-inf") else v
