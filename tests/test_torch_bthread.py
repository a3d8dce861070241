"""The port's bthread layer held against brpc_tpu's, on the CPU.

* Twins, the same script on both packages: the work-stealing queue's
  push / pop / steal sequence (capacity included), the parking lot's
  signal and wait, the butex's wait / wake / requeue results, and the
  thread keys.
* The port alone: Mutex, Cond and CountdownEvent under contention (a
  shortened switch interval, an invariant a lost update would break);
  task start, join and urgent start on a private TaskControl, its bvars,
  and the idle hooks.

Every wait has a deadline; every private TaskControl is stopped.
"""
import sys
import threading
import time

import pytest

import brpc_tpu.bthread as ref_bt
from brpc_tpu.bthread import butex as ref_butex
from brpc_tpu.bthread import parking_lot as ref_pl
from brpc_tpu.bthread import work_stealing_queue as ref_wsq
import brpc_tpu_torch.bthread as bt
from brpc_tpu_torch.bthread import butex as port_butex
from brpc_tpu_torch.bthread import parking_lot as port_pl
from brpc_tpu_torch.bthread import task_control as port_tc
from brpc_tpu_torch.bthread import work_stealing_queue as port_wsq

WAIT_S = 5.0


def _wsq_script(mod):
    q = mod.WorkStealingQueue(capacity=4)
    out = [q.empty()]
    out += [q.push(i) for i in range(6)]  # the last two overflow
    out += [len(q), q.pop(), q.steal(), q.steal(), len(q)]
    out += [q.push(9), q.pop(), q.pop(), q.pop(), q.steal(), q.empty()]
    return out


def test_work_stealing_queue_twin():
    assert _wsq_script(port_wsq) == _wsq_script(ref_wsq)
    # owner end LIFO, thief end FIFO
    assert _wsq_script(port_wsq)[7:11] == [4, 3, 0, 1]


def _parking_script(mod):
    lot = mod.ParkingLot()
    s0 = lot.get_state()
    lot.signal(2)
    moved = lot.wait(s0, timeout=0.01)  # the state moved: no sleep
    s1 = lot.get_state()
    t0 = time.monotonic()
    timed_out = lot.wait(s1, timeout=0.02)
    waited = time.monotonic() - t0 >= 0.015
    lot.stop()
    return [s0, moved, s1, timed_out, waited, lot.stopped(),
            lot.get_state() & ~mod.ParkingLot.STOP_BIT]


def test_parking_lot_twin():
    assert _parking_script(port_pl) == _parking_script(ref_pl)


def _butex_script(mod):
    out = []
    b = mod.butex_create(5)
    out.append(mod.butex_wait(b, 4, timeout=0.01))  # value moved: at once
    out.append(mod.butex_wake(b))  # nobody waits
    woke = []
    waiters = [threading.Thread(target=lambda: woke.append(b.wait(5, WAIT_S)))
               for _ in range(3)]
    for t in waiters:
        t.start()
    deadline = time.monotonic() + WAIT_S
    while len(b._waiters) < 3 and time.monotonic() < deadline:
        time.sleep(0.001)
    dest = mod.Butex(0)
    out.append(b.requeue(dest))  # one woken, two moved
    out.append((len(b._waiters), len(dest._waiters)))
    out.append(mod.butex_wake_all(dest))
    for t in waiters:
        t.join(WAIT_S)
        out.append(t.is_alive())
    out.append(sorted(woke))
    return out


def test_butex_twin():
    got = _butex_script(port_butex)
    assert got == _butex_script(ref_butex)
    assert got[:4] == [False, 0, 3, (0, 2)]


def test_keys_twin():
    for mod in (bt, ref_bt):
        k = mod.key_create()
        assert mod.getspecific(k) is None
        mod.setspecific(k, "v")
        other = []
        t = threading.Thread(target=lambda: other.append(mod.getspecific(k)))
        t.start()
        t.join(WAIT_S)
        assert (mod.getspecific(k), other) == ("v", [None])


@pytest.fixture
def switchy():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def test_mutex_cond_countdown(switchy):
    mu, cond = bt.Mutex(), bt.Cond()
    state = {"n": 0, "ready": 0}
    n_threads, rounds = 8, 200
    done = bt.CountdownEvent(n_threads)

    def work():
        for _ in range(rounds):
            with mu:
                v = state["n"]
                state["n"] = v + 1  # a lost update shows in the total
        with mu:
            state["ready"] += 1
            cond.broadcast()
        done.signal()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    assert done.wait(WAIT_S)
    with mu:
        deadline = time.monotonic() + WAIT_S
        while state["ready"] < n_threads and time.monotonic() < deadline:
            cond.wait(mu, timeout=0.1)
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()
    assert state == {"n": n_threads * rounds, "ready": n_threads}
    late = bt.CountdownEvent(1)
    assert not late.wait(timeout=0.01)  # nobody signals: it times out
    late.add_count(1)
    late.signal(2)
    assert late.wait(timeout=0.01)


@pytest.fixture
def control():
    bt.get_task_control()  # the process's control keeps the bvar names
    tc = port_tc.TaskControl(2)
    try:
        yield tc
    finally:
        tc.stop_and_join()


def test_task_start_join_urgent(control):
    ran = []
    gate = threading.Event()
    tids = [control.start_background(lambda i=i: (gate.wait(WAIT_S),
                                                  ran.append(i)))
            for i in range(2)]  # both workers wait on the gate
    urgent = control.start_urgent(lambda: ran.append("urgent"))
    queued = control.start_background(lambda: ran.append("queued"))
    gate.set()
    for tid in tids + [urgent, queued]:
        assert control.join(tid, WAIT_S)
    assert sorted(map(str, ran)) == ["0", "1", "queued", "urgent"]
    # a joined or unknown tid reads as finished
    assert control.join(tids[0], 0) and control.join(12345, 0)
    deadline = time.monotonic() + WAIT_S
    while (control._finished_var.get_value() < 4
           and time.monotonic() < deadline):
        time.sleep(0.001)
    assert control._finished_var.get_value() == 4
    assert control._nswitch_var.get_value() == 4
    assert control._queued_count() == 0
    # the process-wide calls reach the shared control
    ev = threading.Event()
    tid = bt.start_background(ev.set)
    assert bt.bthread_join(tid, WAIT_S) and ev.is_set()


def test_task_raising_does_not_stop_its_worker(control):
    def boom():
        raise RuntimeError("boom")

    tid = control.start_background(boom)
    assert control.join(tid, WAIT_S)
    ev = threading.Event()
    control.start_background(ev.set)
    assert ev.wait(WAIT_S)


def test_idle_hooks_run_when_idle(control):
    polled = threading.Event()

    def hook():
        polled.set()
        return False

    control.init()
    control.add_idle_hook(hook)
    control.start_background(lambda: None)  # wakes a worker
    assert polled.wait(WAIT_S)
