"""bthread — the client's concurrency pieces: the timer thread and the
versioned call ids. Task control, butexes and execution queues come with
the reference-grade server; the port runs one OS thread per connection
instead."""
from brpc_tpu_torch.bthread import id as bthread_id  # noqa: F401
from brpc_tpu_torch.bthread.timer_thread import (  # noqa: F401
    TimerThread,
    get_global_timer_thread,
    timer_add,
    timer_del,
)
