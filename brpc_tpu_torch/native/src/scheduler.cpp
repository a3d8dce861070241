// See scheduler.h. Fiber switching uses ucontext (portable stand-in for the
// reference's fcontext asm, bthread/context.cpp); stacks are mmap'd with a
// guard page like bthread's StackPool (stack_inl.h:36-105).
#include "scheduler.h"

#include "nat_res.h"
#include "nat_stats.h"

#include <sys/mman.h>
#include <cassert>
#include <chrono>
#include <cstdio>
#include <random>

// Sanitizer fiber protocol (ThreadSanitizer/ASan practice for custom
// context switching, per the compiler-rt fiber interfaces): the asm
// fctx_swap is invisible to the runtimes, so every switch tells ASan
// which stack becomes live (__sanitizer_start/finish_switch_fiber) and
// TSan which logical thread runs (__tsan_switch_to_fiber). Without these
// the sanitizer lanes (make asan / make tsan) report stack-buffer
// false positives on every fiber hop.
#if defined(__SANITIZE_ADDRESS__)
#include <pthread.h>
#include <sanitizer/common_interface_defs.h>
#endif
#if defined(__SANITIZE_THREAD__)
#include <sanitizer/tsan_interface.h>
#endif

namespace brpc_tpu {

#if BRPC_TPU_FCTX
// Register-only context switch, SysV x86-64: saves the callee-saved set on
// the current stack, publishes the stack pointer, and resumes the target.
// No signal-mask save/restore (the two rt_sigprocmask syscalls that make
// swapcontext ~10x slower) — same tradeoff as bthread's fcontext asm.
extern "C" void fctx_swap(void** save_sp, void* to_sp);
asm(".text\n"
    ".globl fctx_swap\n"
    ".type fctx_swap,@function\n"
    "fctx_swap:\n"
    "  pushq %rbp\n"
    "  pushq %rbx\n"
    "  pushq %r12\n"
    "  pushq %r13\n"
    "  pushq %r14\n"
    "  pushq %r15\n"
    "  movq %rsp, (%rdi)\n"
    "  movq %rsi, %rsp\n"
    "  popq %r15\n"
    "  popq %r14\n"
    "  popq %r13\n"
    "  popq %r12\n"
    "  popq %rbx\n"
    "  popq %rbp\n"
    "  ret\n"
    ".size fctx_swap,.-fctx_swap\n");

// Build the initial context: a stack image that fctx_swap's epilogue pops
// and whose `ret` lands in `entry` with ABI-correct alignment
// (rsp % 16 == 8 at function entry).
static void* fctx_make(char* stack_top, void (*entry)()) {
  uint64_t* sp16 = (uint64_t*)((uintptr_t)stack_top & ~(uintptr_t)0xF);
  uint64_t* p = sp16;
  *--p = 0;                  // keeps the ret slot 16-aligned
  *--p = (uint64_t)entry;    // ret target
  for (int i = 0; i < 6; i++) *--p = 0;  // r15 r14 r13 r12 rbx rbp
  return p;
}
#endif

static thread_local Worker* tls_worker = nullptr;
static thread_local std::vector<Fiber*>* tls_wake_batch = nullptr;

// Fiber bodies migrate threads across swapcontext, but -O2 CSEs the TLS
// address within a function (it assumes one thread per activation). Every
// read that can happen AFTER a potential migration must go through this
// noinline accessor so the DTV lookup is redone on the current thread.
__attribute__((noinline)) static Worker* current_worker() {
  Worker* w = tls_worker;
  asm volatile("" : "+r"(w));  // defeat IPA/CSE across calls
  return w;
}

static const size_t kStackSize = 256 * 1024;

// Fiber object alloc/release seams (the ledger pairs them; the stacks
// account separately at the mmap/munmap above, so a pooled stack stays
// LIVE while a reaped Fiber does not).
static Fiber* fiber_new() {
  Fiber* f = new Fiber();
  NAT_RES_ALLOC(NR_SCHED_STACK, sizeof(Fiber), f);
  return f;
}

static void fiber_delete(Fiber* f) {
  NAT_RES_FREE(NR_SCHED_STACK, sizeof(Fiber), f);
  delete f;
}

// Pooled stacks (StackPool role, stack_inl.h:36-105): per-request fibers
// must not pay an mmap/munmap round trip each spawn. POD storage on
// purpose: detached worker threads outlive exit()'s static destructors
// (BENCH_r05 rc 139 — a ~vector here would free the pool under a worker
// still reaping fibers), and trivially-destructible globals stay valid
// for the whole process lifetime.
static NatMutex<kLockRankStackPool> g_stack_pool_mu;
static const size_t kStackPoolCap = 256;
static char* g_stack_pool[kStackPoolCap];
static size_t g_stack_pool_n = 0;

// natcheck:leak(alloc_stack): fiber stacks cached in the process-
// lifetime stack pool (StackPool role); fibers still queued at exit()
// keep theirs.
static char* alloc_stack(size_t size) {
  {
    std::lock_guard g(g_stack_pool_mu);
    if (g_stack_pool_n > 0) {
      return g_stack_pool[--g_stack_pool_n];
    }
  }
  void* mem = mmap(nullptr, size + 4096, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (mem == MAP_FAILED) return nullptr;
  NAT_RES_ALLOC(NR_SCHED_STACK, size + 4096, mem);
  mprotect(mem, 4096, PROT_NONE);  // guard page
  return (char*)mem + 4096;
}

static void free_stack(char* stack, size_t size) {
  {
    std::lock_guard g(g_stack_pool_mu);
    if (g_stack_pool_n < kStackPoolCap) {
      g_stack_pool[g_stack_pool_n++] = stack;
      return;
    }
  }
  NAT_RES_FREE(NR_SCHED_STACK, size + 4096, stack - 4096);
  munmap(stack - 4096, size + 4096);
}

void Worker::signal() {
  // seq_cst store-then-load pairs with the waiter's parked-then-recheck
  // (Dekker): either we see parked > 0 and notify, or the waiter's
  // park_signal recheck sees our bump and skips the sleep.
  park_signal.fetch_add(1, std::memory_order_seq_cst);
  if (parked.load(std::memory_order_seq_cst) > 0) {
    {
      std::lock_guard g(park_mu);
    }
    park_cv.notify_one();
  }
}

void Scheduler::wake_one() {
  if (workers_.empty()) return;
  uint32_t i = wake_rr_.fetch_add(1, std::memory_order_relaxed);
  workers_[i % workers_.size()]->signal();
}

Scheduler* Scheduler::instance() {
  // natcheck:leak(Scheduler::instance): worker threads are detached from
  // the process's point of view and keep scheduling through exit(). A
  // function-local `static Scheduler s` is destroyed by __cxa_atexit
  // while they still iterate workers_ — the use-after-free behind the
  // bench-exit SIGSEGV (BENCH_r05 rc 139). The reference never destructs
  // its TaskControl either. (natcheck:leak(Scheduler::start): the Worker
  // structs and worker std::threads start() spawns share this lifetime.)
  static Scheduler* s = new Scheduler();
  return s;
}

int Scheduler::start(int nworkers) {
  if (started_) return 0;
  stopping_ = false;
  for (int i = 0; i < nworkers; i++) {
    Worker* w = new Worker();
    NAT_RES_ALLOC(NR_SCHED_STACK, sizeof(Worker), w);
    w->sched = this;
    w->id = i;
    workers_.push_back(w);
  }
  for (Worker* w : workers_) {
    w->thread = std::thread([this, w] { worker_loop(w); });
  }
  started_ = true;
  return 0;
}

void Scheduler::stop() {
  if (!started_) return;
  stopping_ = true;
  for (Worker* w : workers_) w->signal();
  for (Worker* w : workers_) {
    if (w->thread.joinable()) w->thread.join();
  }
  for (Worker* w : workers_) {
    NAT_RES_FREE(NR_SCHED_STACK, sizeof(Worker), w);
    delete w;
  }
  workers_.clear();
  started_ = false;
}


// Switch the running fiber out to this worker's main loop / resume a fiber.
// `terminal` = the fiber is finishing and will never resume: its ASan fake
// stack is released instead of saved.
static inline void switch_out_to_main(Worker* w, Fiber* f,
                                      bool terminal = false) {
#if defined(NAT_LOCKRANK)
  // a NatMutex held across a switch would be "held" by a TLS stack the
  // fiber is about to leave — the rank validator's runtime twin of the
  // static lock-switch rule
  lockrank::assert_none_held("switch_out_to_main");
#endif
#if defined(__SANITIZE_ADDRESS__)
  __sanitizer_start_switch_fiber(terminal ? nullptr : &f->asan_fake_stack,
                                 w->pthread_stack_bottom,
                                 w->pthread_stack_size);
#else
  (void)terminal;
#endif
#if defined(__SANITIZE_THREAD__)
  __tsan_switch_to_fiber(w->tsan_main_fiber, 0);
#endif
#if BRPC_TPU_FCTX
  fctx_swap(&f->sp, w->main_sp);
#else
  swapcontext(&f->ctx, &w->main_ctx);
#endif
#if defined(__SANITIZE_ADDRESS__)
  // resumed (possibly on a different worker thread)
  __sanitizer_finish_switch_fiber(f->asan_fake_stack, nullptr, nullptr);
#endif
}
static inline void switch_into_fiber(Worker* w, Fiber* f) {
#if defined(NAT_LOCKRANK)
  lockrank::assert_none_held("switch_into_fiber");
#endif
#if defined(__SANITIZE_ADDRESS__)
  __sanitizer_start_switch_fiber(&w->asan_fake_stack, f->stack,
                                 f->stack_size);
#endif
#if defined(__SANITIZE_THREAD__)
  __tsan_switch_to_fiber(f->tsan_fiber, 0);
#endif
#if BRPC_TPU_FCTX
  fctx_swap(&w->main_sp, f->sp);
#else
  swapcontext(&w->main_ctx, &f->ctx);
#endif
#if defined(__SANITIZE_ADDRESS__)
  __sanitizer_finish_switch_fiber(w->asan_fake_stack, nullptr, nullptr);
#endif
}

#if defined(__SANITIZE_THREAD__)
static void sanitize_fiber_create(Fiber* f) {
  f->tsan_fiber = __tsan_create_fiber(0);
}
static void sanitize_fiber_destroy(Fiber* f) {
  if (f->tsan_fiber != nullptr) __tsan_destroy_fiber(f->tsan_fiber);
}
#else
static inline void sanitize_fiber_create(Fiber*) {}
static inline void sanitize_fiber_destroy(Fiber*) {}
#endif

static void fiber_trampoline();

static void init_fiber_ctx(Fiber* f) {
#if BRPC_TPU_FCTX
  f->sp = fctx_make(f->stack + f->stack_size, fiber_trampoline);
#else
  getcontext(&f->ctx);
  f->ctx.uc_stack.ss_sp = f->stack;
  f->ctx.uc_stack.ss_size = f->stack_size;
  f->ctx.uc_link = nullptr;
  makecontext(&f->ctx, (void (*)())fiber_trampoline, 0);
#endif
}

Fiber* Scheduler::spawn(FiberFn fn, void* arg) {
  Fiber* f = fiber_new();
  f->fn = fn;
  f->arg = arg;
  f->stack = alloc_stack(kStackSize);
  f->stack_size = kStackSize;
  sanitize_fiber_create(f);
  init_fiber_ctx(f);
  ready_fiber(f);
  return f;
}

void Scheduler::spawn_detached(FiberFn fn, void* arg) {
  Fiber* f = fiber_new();
  f->detached = true;
  f->fn = fn;
  f->arg = arg;
  f->stack = alloc_stack(kStackSize);
  f->stack_size = kStackSize;
  sanitize_fiber_create(f);
  init_fiber_ctx(f);
  ready_fiber(f);
}

void Scheduler::spawn_detached_back(FiberFn fn, void* arg) {
  Fiber* f = fiber_new();
  f->detached = true;
  f->fn = fn;
  f->arg = arg;
  f->stack = alloc_stack(kStackSize);
  f->stack_size = kStackSize;
  sanitize_fiber_create(f);
  init_fiber_ctx(f);
  f->state.store(FiberState::READY, std::memory_order_release);
  // Remote queues are FIFO and drained only when the local deque is empty:
  // every already-ready producer runs before this fiber.
  uint32_t idx =
      next_worker_.fetch_add(1, std::memory_order_relaxed) % workers_.size();
  Worker* target = workers_[idx];
  {
    std::lock_guard g(target->remote_mu);
    target->remote_rq.push_back(f);
  }
  target->signal();
}

void Scheduler::arm_wake_batch(std::vector<Fiber*>* batch) {
  tls_wake_batch = batch;
}

void Scheduler::flush_wake_batch() {
  std::vector<Fiber*>* batch = tls_wake_batch;
  tls_wake_batch = nullptr;
  if (batch == nullptr || batch->empty()) return;
  size_t n = batch->size();
  size_t nw = workers_.size();
  size_t chunks = n < nw ? n : nw;
  uint32_t base =
      next_worker_.fetch_add((uint32_t)chunks, std::memory_order_relaxed);
  size_t idx = 0;
  for (size_t c = 0; c < chunks; c++) {
    size_t take = n / chunks + (c < n % chunks ? 1 : 0);
    Worker* t = workers_[(base + c) % nw];
    {
      std::lock_guard g(t->remote_mu);
      for (size_t i = 0; i < take; i++) {
        t->remote_rq.push_back((*batch)[idx++]);
      }
    }
    t->signal();
  }
  batch->clear();
}

void Scheduler::ready_fiber(Fiber* f) {
  f->state.store(FiberState::READY, std::memory_order_release);
  if (tls_wake_batch != nullptr) {
    tls_wake_batch->push_back(f);
    return;
  }
  Worker* w = current_worker();
  if (w != nullptr) {
    if (w->rq.push(f)) {
      // A sibling may be parked while our local queue fills: poke one.
      Worker* peer =
          workers_[(w->id + 1) % workers_.size()];
      if (peer != w) peer->signal();
      return;
    }
  }
  // From a non-worker thread (or full local queue): remote-queue a worker
  // round-robin and wake it (start_background REMOTE path).
  uint32_t idx =
      next_worker_.fetch_add(1, std::memory_order_relaxed) % workers_.size();
  Worker* target = workers_[idx];
  {
    std::lock_guard g(target->remote_mu);
    target->remote_rq.push_back(f);
  }
  target->signal();
}

Fiber* Scheduler::next_task(Worker* w) {
  Fiber* f = nullptr;
  if (w->rq.pop(&f)) return f;
  {
    std::lock_guard g(w->remote_mu);
    if (!w->remote_rq.empty()) {
      f = w->remote_rq.front();
      w->remote_rq.pop_front();
      return f;
    }
  }
  // steal (task_control.h:55)
  static thread_local std::mt19937 rng(std::random_device{}());
  size_t n = workers_.size();
  if (n > 1) {
    size_t start = rng() % n;
    for (size_t i = 0; i < n; i++) {
      Worker* v = workers_[(start + i) % n];
      if (v == w) continue;
      if (v->rq.steal(&f)) {
        nat_counter_add(NS_WSQ_STEALS, 1);  // /vars: cross-core balance
        return f;
      }
      {
        std::lock_guard g(v->remote_mu);
        if (!v->remote_rq.empty()) {
          f = v->remote_rq.front();
          v->remote_rq.pop_front();
          return f;
        }
      }
    }
  }
  return nullptr;
}

static void fiber_trampoline() {
#if defined(__SANITIZE_ADDRESS__)
  // first entry into this context: no prior fake stack to restore
  __sanitizer_finish_switch_fiber(nullptr, nullptr, nullptr);
#endif
  Worker* w = current_worker();
  Fiber* f = w->current;
  f->fn(f->arg);
  // The body may have blocked and been stolen: we can resume on a
  // DIFFERENT worker than the one that first ran us. Always finish
  // against the worker this thread belongs to now.
  w = current_worker();
  f->state.store(FiberState::DONE, std::memory_order_release);
  // Publish completion only after leaving this stack: a joiner (or the
  // detached self-reap) frees the stack, so it must happen from the worker
  // loop (ending_sched).
  w->remained_op = f->detached ? Worker::RemainedOp::FINISH_DETACHED
                               : Worker::RemainedOp::FINISH_JOINABLE;
  w->remained_fiber = f;
  switch_out_to_main(w, f, /*terminal=*/true);
}

void Scheduler::run_fiber(Worker* w, Fiber* f) {
  w->current = f;
  f->state.store(FiberState::RUNNING, std::memory_order_release);
  w->nswitch++;
  switch_into_fiber(w, f);
  w->current = nullptr;
  switch (w->remained_op) {
    case Worker::RemainedOp::NONE:
      break;
    case Worker::RemainedOp::READY: {
      Fiber* rf = w->remained_fiber;
      w->remained_op = Worker::RemainedOp::NONE;
      rf->state.store(FiberState::READY, std::memory_order_release);
      ready_fiber(rf);
      break;
    }
    case Worker::RemainedOp::BUTEX_ENQUEUE: {
      Fiber* rf = w->remained_fiber;
      Butex* b = w->remained_butex;
      int32_t expected = w->remained_expected;
      w->remained_op = Worker::RemainedOp::NONE;
      std::unique_lock g(b->mu);
      // publish-then-check (Dekker): the RMW increment is a full barrier
      // that pairs with butex_wake's fence-then-load — incrementing
      // AFTER the value check would let a concurrent waker miss both
      // the waiter and the waiter miss the new value
      b->nwaiters.fetch_add(1, std::memory_order_seq_cst);
      if (b->value.load(std::memory_order_acquire) != expected) {
        b->nwaiters.fetch_sub(1, std::memory_order_relaxed);
        g.unlock();
        ready_fiber(rf);  // value already moved: spurious-wake ourselves
      } else {
        b->waiters.push_back(rf);
      }
      break;
    }
    case Worker::RemainedOp::FINISH_JOINABLE: {
      Fiber* rf = w->remained_fiber;
      w->remained_op = Worker::RemainedOp::NONE;
      rf->join_butex.value.store(1, std::memory_order_release);
      Scheduler::butex_wake(&rf->join_butex, INT32_MAX);
      // only NOW may join() delete rf: the wake above is fully done
      // touching the butex that lives inside the fiber
      rf->join_wake_done.store(1, std::memory_order_release);
      break;
    }
    case Worker::RemainedOp::FINISH_DETACHED: {
      Fiber* rf = w->remained_fiber;
      w->remained_op = Worker::RemainedOp::NONE;
      sanitize_fiber_destroy(rf);
      free_stack(rf->stack, rf->stack_size);
      fiber_delete(rf);
      break;
    }
  }
}

void Scheduler::worker_loop(Worker* w) {
  tls_worker = w;
#if defined(__SANITIZE_ADDRESS__)
  {
    pthread_attr_t attr;
    pthread_getattr_np(pthread_self(), &attr);
    void* addr = nullptr;
    size_t sz = 0;
    pthread_attr_getstack(&attr, &addr, &sz);
    pthread_attr_destroy(&attr);
    w->pthread_stack_bottom = addr;
    w->pthread_stack_size = sz;
  }
#endif
#if defined(__SANITIZE_THREAD__)
  w->tsan_main_fiber = __tsan_get_current_fiber();
#endif
  while (!stopping_.load(std::memory_order_acquire)) {
    // Read the lot BEFORE scanning queues: a push+signal landing between
    // the scan and the park is then visible as a changed park_signal and
    // the park is skipped (the ParkingLot expected-state discipline).
    uint32_t expected = w->park_signal.load(std::memory_order_acquire);
    Fiber* f = next_task(w);
    if (f != nullptr) {
      run_fiber(w, f);
      // Task-boundary hook pass (the fork drains its ring queue in
      // wait_task between tasks, task_group.cpp:158-169): under
      // sustained fiber load a worker never goes idle, so completions
      // would starve if hooks only ran on full idleness.
      if ((++w->boundary_ticks & 63) == 0) {
        std::shared_ptr<std::vector<std::function<bool()>>> hooks;
        {
          std::lock_guard g(hooks_mu_);
          hooks = idle_hooks_;
        }
        if (hooks) {
          for (auto& h : *hooks) h();
        }
      }
      continue;
    }
    // idle: run hooks (the libtpu/ext-processor seam), then park.
    // The hook list is copy-on-write: grab the snapshot under the lock,
    // run the hooks outside it so a slow hook never blocks other
    // workers' idle paths.
    bool did_work = false;
    std::shared_ptr<std::vector<std::function<bool()>>> hooks;
    {
      std::lock_guard g(hooks_mu_);
      hooks = idle_hooks_;
    }
    if (hooks) {
      for (auto& h : *hooks) did_work |= h();
    }
    if (did_work) continue;
    // /vars idle-vs-busy shape: counted BEFORE park_mu — the first add
    // on a thread registers its stat cell (g_cell_mu, rank 78), which
    // must not nest inside the rank-94 parking lot
    nat_counter_add(NS_WORKER_PARKS, 1);
    std::unique_lock lk(w->park_mu);
    // Publish parked BEFORE the final recheck (Dekker pairing with
    // signal()'s bump-then-load): a signaler that misses parked>0 must
    // have bumped before our recheck, which then sees it and skips.
    w->parked.fetch_add(1, std::memory_order_seq_cst);
    if (w->park_signal.load(std::memory_order_seq_cst) != expected) {
      w->parked.fetch_sub(1, std::memory_order_relaxed);
      continue;
    }
    nat_cv_wait_for(w->park_cv, lk, std::chrono::milliseconds(100));
    w->parked.fetch_sub(1, std::memory_order_relaxed);
  }
  tls_worker = nullptr;
}

void Scheduler::yield() {
  Worker* w = current_worker();
  if (w == nullptr || w->current == nullptr) return;
  Fiber* f = w->current;
  // Requeue only after switching out (remained), else a thief could run
  // this fiber while it is still on this stack.
  w->remained_op = Worker::RemainedOp::READY;
  w->remained_fiber = f;
  switch_out_to_main(w, f);
}

Fiber* Scheduler::current() {
  Worker* w = current_worker();
  return w ? w->current : nullptr;
}

bool Scheduler::butex_wait(Butex* b, int32_t expected) {
  Worker* w = current_worker();
  if (w == nullptr || w->current == nullptr) {
    // pthread waiter (reference: real futex path, butex.cpp:297): block on
    // the butex's condvar; butex_wake notifies it. Recheck under the lock
    // so a change-then-wake between the load and the wait is never missed.
    std::unique_lock g(b->mu);
    // publish the waiter BEFORE checking the value (the RMW is a full
    // barrier): pairs with butex_wake's fence-then-load so at least one
    // side observes the other — no missed pthread wake
    b->nwaiters.fetch_add(1, std::memory_order_seq_cst);
    while (b->value.load(std::memory_order_acquire) == expected) {
      ++b->pthread_waiters;
      nat_cv_wait_for(b->pthread_cv, g, std::chrono::milliseconds(100));
      --b->pthread_waiters;
    }
    b->nwaiters.fetch_sub(1, std::memory_order_relaxed);
    return true;
  }
  Fiber* f = w->current;
  if (b->value.load(std::memory_order_acquire) != expected) return false;
  f->state.store(FiberState::BLOCKED, std::memory_order_release);
  // Enqueue to the waiter list only after leaving this stack; the lambda
  // rechecks the value so a concurrent change-then-wake is never missed
  // (the butex_wait ordering discipline of butex.cpp:258).
  w->remained_op = Worker::RemainedOp::BUTEX_ENQUEUE;
  w->remained_fiber = f;
  w->remained_butex = b;
  w->remained_expected = expected;
  switch_out_to_main(w, f);  // parked; wake requeues us
  return true;
}

int Scheduler::butex_wake(Butex* b, int n) {
  // Lock-free fast path: no waiter was parked when we looked. The fence
  // pairs with the waiter-side RMW increment (classic store-buffer
  // pairing): either we see the waiter and take the lock, or the waiter
  // sees our caller's already-stored value when it rechecks under mu and
  // self-wakes — no missed wake either way.
  std::atomic_thread_fence(std::memory_order_seq_cst);
  if (b->nwaiters.load(std::memory_order_relaxed) == 0) return 0;
  std::deque<Fiber*> woken;
  {
    std::lock_guard g(b->mu);
    while (!b->waiters.empty() && n-- > 0) {
      woken.push_back(b->waiters.front());
      b->waiters.pop_front();
      b->nwaiters.fetch_sub(1, std::memory_order_relaxed);
    }
    if (b->pthread_waiters > 0) b->pthread_cv.notify_all();
  }
  Scheduler* s = Scheduler::instance();
  for (Fiber* f : woken) s->ready_fiber(f);
  return (int)woken.size();
}

void Scheduler::join(Fiber* f) {
  // Single-joiner contract. From a non-fiber thread this spins on the
  // butex; from a fiber it parks.
  while (f->join_butex.value.load(std::memory_order_acquire) == 0) {
    butex_wait(&f->join_butex, 0);
  }
  // Synchronize with the completion wake: once we hold/release the butex
  // mutex, the finishing worker is done touching the waiter list...
  { std::lock_guard g(f->join_butex.mu); }
  // ...but butex_wake's lock-free fast path (fence + nwaiters probe)
  // touches the butex WITHOUT the mutex — spin out the tail of the wake
  // before freeing the memory it reads (nanoseconds; the waker needs no
  // cooperation from this thread to finish).
  while (f->join_wake_done.load(std::memory_order_acquire) == 0) {
    std::this_thread::yield();
  }
  sanitize_fiber_destroy(f);
  free_stack(f->stack, f->stack_size);
  fiber_delete(f);
}

uint64_t Scheduler::total_switches() const {
  uint64_t total = 0;
  for (Worker* w : workers_) total += w->nswitch;
  return total;
}

}  // namespace brpc_tpu
