// M:N fiber scheduler — the native bthread core.
//
// Counterpart of bthread's TaskControl/TaskGroup/butex
// (/root/reference/src/bthread/task_control.h, task_group.cpp, butex.cpp):
// N worker pthreads, each owning a lock-free work-stealing runqueue and a
// parking lot; fibers are ucontext stacks (the role of the hand-written
// fcontext asm, bthread/context.cpp); butex gives fibers futex-shaped
// blocking; the idle loop accepts pluggable hooks — the seam where the
// monographdb fork runs io_uring/ext-processor work and where a TPU build
// polls libtpu completions (SURVEY.md section 2.10).
#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <ucontext.h>
#include <vector>

#include "nat_lockrank.h"
#include "wsq.h"

namespace brpc_tpu {

// Timed condition-variable wait for runtime poll loops. TSan's interceptor
// set (gcc 10) lacks pthread_cond_clockwait, which libstdc++ uses for the
// steady-clock wait_for: the runtime then never observes the mutex release
// inside the wait and reports a phantom "double lock" against every waker.
// Under TSan only, route through wait_until on the system clock
// (pthread_cond_timedwait, which IS intercepted); production builds keep
// the steady-clock wait_for. All call sites are periodic poll loops that
// recheck state, so a clock jump costs at most one early/late poll tick.
template <typename Rep, typename Period>
inline void nat_cv_wait_for(std::condition_variable& cv,
                            std::unique_lock<std::mutex>& lk,
                            std::chrono::duration<Rep, Period> d) {
#if defined(__SANITIZE_THREAD__)
  cv.wait_until(lk, std::chrono::system_clock::now() + d);
#else
  cv.wait_for(lk, d);
#endif
}

using FiberFn = void (*)(void*);

struct Fiber;
class Scheduler;

struct Butex {
  std::atomic<int32_t> value{0};
  // cv partner (pthread_cv below waits under it): must stay std::mutex.
  std::mutex mu;  // natcheck:rank(butex, 90)
  std::deque<Fiber*> waiters;
  // pthread waiters (the real-futex path of butex.cpp:297) block here
  // instead of spinning; butex_wake notifies when any are parked.
  std::condition_variable pthread_cv;
  int pthread_waiters = 0;
  // fiber + pthread waiter count, maintained under mu but READABLE
  // without it: wakers store the value BEFORE waking and enqueuers
  // recheck the value under mu, so a zero snapshot lets butex_wake skip
  // the lock entirely (the common nobody-parked case — e.g. every
  // EPOLLOUT edge and most async window updates).
  std::atomic<int> nwaiters{0};
};

enum class FiberState : uint8_t { READY, RUNNING, BLOCKED, DONE };

// On x86-64 we switch contexts with a register-only asm routine (the
// fcontext discipline of bthread/context.cpp): ucontext's swapcontext
// issues two rt_sigprocmask syscalls per switch, which dominates fiber
// ping-pong cost (~1.2us measured vs ~100ns register-only).
#if defined(__x86_64__)
#define BRPC_TPU_FCTX 1
#endif

struct Fiber {
#if BRPC_TPU_FCTX
  void* sp = nullptr;  // saved stack pointer (callee-saved regs below it)
#else
  ucontext_t ctx;
#endif
#if defined(__SANITIZE_ADDRESS__)
  void* asan_fake_stack = nullptr;  // fake-stack save across switches
#endif
#if defined(__SANITIZE_THREAD__)
  void* tsan_fiber = nullptr;  // TSan context (__tsan_create_fiber)
#endif
  char* stack = nullptr;
  size_t stack_size = 0;
  FiberFn fn = nullptr;
  void* arg = nullptr;
  std::atomic<FiberState> state{FiberState::READY};
  Butex join_butex;  // value 0 = running, 1 = done
  // set AFTER the completion butex_wake returns: join() must not free
  // this fiber (the butex lives inside it) while the waker may still be
  // in butex_wake's lock-free nwaiters probe — the use-after-free
  // window the PR-2 bench leak worked around, closed at the source
  std::atomic<uint32_t> join_wake_done{0};
  bool detached = false;  // self-reaping; never joined
};

class Worker {
 public:
  WorkStealingQueue<Fiber*> rq;
  NatMutex<kLockRankSchedRemote> remote_mu;
  std::deque<Fiber*> remote_rq;
  // parking lot (per worker, as in the fork: task_control.h:123-126);
  // park_cv waits under park_mu, so it must stay std::mutex.
  std::mutex park_mu;  // natcheck:rank(sched.park, 94)
  std::condition_variable park_cv;
  std::atomic<uint32_t> park_signal{0};
  std::atomic<int> parked{0};  // gate: skip notify when nobody sleeps
  uint32_t boundary_ticks = 0;  // task-boundary hook cadence (worker-local)
  std::thread thread;
  Scheduler* sched = nullptr;
  int id = 0;
#if BRPC_TPU_FCTX
  void* main_sp = nullptr;  // worker loop's saved context
#else
  ucontext_t main_ctx;  // the worker loop's context
#endif
#if defined(__SANITIZE_ADDRESS__)
  void* asan_fake_stack = nullptr;      // main context's fake-stack save
  const void* pthread_stack_bottom = nullptr;  // this worker's own stack
  size_t pthread_stack_size = 0;
#endif
#if defined(__SANITIZE_THREAD__)
  void* tsan_main_fiber = nullptr;  // worker thread's implicit TSan fiber
#endif
  Fiber* current = nullptr;
  uint64_t nswitch = 0;
  // Runs on the worker loop right after a fiber switches out — the
  // remained-callback mechanism (task_group.h:114-118) that lets a fiber
  // publish itself to a wait queue only AFTER it left its own stack.
  // POD-encoded (not std::function): it fires on EVERY park/yield/finish
  // and a capturing lambda would heap-allocate each time.
  enum class RemainedOp : uint8_t {
    NONE,
    READY,           // requeue fiber a
    BUTEX_ENQUEUE,   // enqueue fiber a on butex b unless value moved
    FINISH_JOINABLE, // publish completion of fiber a
    FINISH_DETACHED, // reap fiber a
  };
  RemainedOp remained_op = RemainedOp::NONE;
  Fiber* remained_fiber = nullptr;
  Butex* remained_butex = nullptr;
  int32_t remained_expected = 0;

  void signal();
};

class Scheduler {
 public:
  static Scheduler* instance();

  int start(int nworkers);
  void stop();
  bool started() const { return started_; }
  int nworkers() const { return (int)workers_.size(); }

  Fiber* spawn(FiberFn fn, void* arg);
  // Detached spawn (bthread_start_background without a join): the fiber
  // frees its own stack from the worker loop after finishing.
  void spawn_detached(FiberFn fn, void* arg);
  // Like spawn_detached, but scheduled BEHIND every currently-ready fiber
  // (the local deque is owner-LIFO): used by batching writers that want
  // producers to run first so their appends coalesce.
  void spawn_detached_back(FiberFn fn, void* arg);
  void join(Fiber* f);
  static void yield();        // from inside a fiber
  static Fiber* current();    // running fiber or nullptr

  // butex API (butex.h:36-71 analog)
  static bool butex_wait(Butex* b, int32_t expected);
  static int butex_wake(Butex* b, int n);

  void add_idle_hook(std::function<bool()> hook) {
    std::lock_guard g(hooks_mu_);
    auto next = std::make_shared<std::vector<std::function<bool()>>>(
        idle_hooks_ ? *idle_hooks_ : std::vector<std::function<bool()>>());
    next->push_back(std::move(hook));
    idle_hooks_ = std::move(next);  // copy-on-write: workers run hooks
                                    // WITHOUT holding hooks_mu_
  }

  // Wakes one parked worker — external completion sources (RingListener
  // poller, libtpu callbacks) use this so completions don't wait out the
  // park timeout (the ExtWakeup of ring_listener.h:42-63).
  void wake_one();

  // Wake batching for event-loop threads: between arm and flush, every
  // ready_fiber()/spawn from THIS thread collects into `batch` instead
  // of remote-queue+futex per fiber; flush distributes the batch across
  // workers with one lock+signal per worker (amortizing the per-
  // completion futex wake that dominates dispatcher rounds).
  void arm_wake_batch(std::vector<Fiber*>* batch);
  void flush_wake_batch();

  uint64_t total_switches() const;

  // internal
  void worker_loop(Worker* w);
  void ready_fiber(Fiber* f);  // requeue a woken fiber

 private:
  std::vector<Worker*> workers_;
  std::atomic<bool> stopping_{false};
  bool started_ = false;
  std::atomic<uint32_t> next_worker_{0};
  NatMutex<kLockRankSchedHooks> hooks_mu_;
  std::shared_ptr<std::vector<std::function<bool()>>> idle_hooks_;
  std::atomic<uint32_t> wake_rr_{0};

  Fiber* next_task(Worker* w);
  void run_fiber(Worker* w, Fiber* f);
};

}  // namespace brpc_tpu
