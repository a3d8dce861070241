// Lock ranks — the repo's total lock order, checked two ways:
//
//   * statically by tools/natcheck/lockorder.py, which parses every
//     NatMutex<kLockRank...> declaration (and the `natcheck:rank` comment
//     annotations on the few raw mutexes below), builds the
//     acquires-while-holding graph across all TUs and requires the rank
//     to strictly increase on every nested acquisition;
//   * at runtime under -DNAT_LOCKRANK=1 (`make -C native lockrank`, run
//     by `make -C native check`): every NatMutex::lock pushes its rank
//     on a thread-local held stack and aborts if the new rank is not
//     strictly greater than the deepest held one. try_lock acquisitions
//     are exempt from the order assert (a failed try_lock cannot
//     deadlock — that is exactly why the hot paths use them) but still
//     tracked while held.
//
// The discipline re-grows brpc's strict lock ranks around Socket/bthread
// internals as checkable tooling: outer control-plane locks rank low,
// per-session protocol locks mid, socket/ring/stat leaves high, and the
// scheduler's own locks highest (anything may wake a fiber while holding
// its own lock, never the reverse).
//
// Raw (non-NatMutex) locks and their ranks — condition-variable partners
// must stay std::mutex (std::condition_variable demands it), and the shm
// lifetime fence is a cross-process robust pthread mutex:
//
//   15  shm.fence    ShmWorkerHdr::fence   (nat_shm_lane.cpp)
//   57  server.py    NatServer::py_mu      (nat_internal.h)
//   86  timer.run    TimerThread::run_mu_  (timer_thread.h)
//   90  butex        Butex::mu             (scheduler.h)
//   94  sched.park   Worker::park_mu       (scheduler.h)
#pragma once

#include <mutex>

namespace brpc_tpu {

enum : int {
  kLockRankMuSelftest = 4,    // nat_mu_contend_selftest's burn mutex
                              // (holds nothing, held under nothing)
  kLockRankDumpCtl = 5,       // nat_dump g_dump_ctl_mu: flight-recorder
                              // start/stop/status (control path only;
                              // held across the writer join, which
                              // takes no NatMutex of its own)
  kLockRankProfCtl = 6,       // nat_prof g_ctl_mu: start/stop/reset
                              // serialization (control path only; held
                              // across the collector join, which takes
                              // g_report_mu on its own thread)
  kLockRankResReport = 7,     // nat_res g_res_report_mu: allocation-site
                              // collector/report + ledger snapshots
                              // (control path only; the record seams are
                              // lock-free — they run under registry
                              // locks of arbitrary rank)
  kLockRankProfReport = 8,    // nat_prof g_report_mu: collector/report
                              // serialization (holds no other lock while
                              // symbolizing), outermost
  kLockRankMuProfReport = 9,  // nat_prof g_mu_report_mu: contention-
                              // profiler aggregate/report (control path)
  kLockRankShmProbe = 10,     // g_probe_mu: fence probing, outermost
  // 15: shm.fence (raw robust pthread mutex, see header comment)
  kLockRankShmReq = 20,       // g_req_mu[i]: per-worker request producer
  kLockRankShmResp = 22,      // g_resp_mu: worker-side response producer
  kLockRankShmFabric = 24,    // g_fab_mu: producer-side tensor-fabric
                              // push lock (kind-8 records onto the
                              // producer slot's own request ring)
  kLockRankCluster = 28,      // NatCluster::mu: naming-feed diff/publish
                              // (creates channels under it: below the
                              // runtime lock; the LB read path takes NO
                              // lock — the DoublyBufferedData gate)
  kLockRankRuntime = 30,      // g_rt_mu: runtime/server registry
  kLockRankListen = 34,       // Dispatcher::listen_mu
  kLockRankDispClose = 35,    // Dispatcher::pend_close_mu: deferred
                              // listener-fd closes (teardown-race fix)
  kLockRankReconnect = 36,    // NatChannel::reconnect_mu
  kLockRankHttpSess = 40,     // HttpSessionN::http_mu
  kLockRankH2Sess = 42,       // H2SessionN::h2_mu
  kLockRankRedisSess = 44,    // RedisSessN::redis_mu
  kLockRankRedisStore = 46,   // RedisStoreN::store_mu
  kLockRankHttpCli = 50,      // HttpCliSessN::httpc_mu
  kLockRankH2Cli = 52,        // H2CliSessN::h2c_mu
  kLockRankSslSess = 54,      // SslSessionN::ssl_mu (sessions write
                              // through the TLS session: session < ssl)
  kLockRankBreaker = 55,      // NatChannel::breaker_mu (fed from
                              // take_pending, which client-lane readers
                              // may reach while holding session locks)
  kLockRankChanGrow = 56,     // NatChannel::grow_mu_
  // 57: server.py (raw, cv partner)
  kLockRankShmInflight = 58,  // g_inflight_mu: reaper table
  kLockRankOverload = 59,     // g_adm_mu: auto-limiter window (completion
                              // accounting runs under py_mu/inflight)
  kLockRankSockAlloc = 60,    // g_sock_alloc_mu: registry slab/freelist
  kLockRankSockEpoll = 62,    // NatSocket::epollctl_mu: EPOLLOUT
                              // arm/disarm arbitration (cold path; the
                              // write hot path itself is the wait-free
                              // MPSC stack of nat_wstack.h — lockless)
  kLockRankRingRetry = 64,    // g_ring_retry_mu
  kLockRankRingFiles = 66,    // RingListener::files_mu_
  kLockRankRingSq = 68,       // RingListener::sq_mu_
  kLockRankRingSend = 70,     // RingListener::send_mu_ (the SQ-full
                              // failure path returns its send buffer
                              // while still holding sq_mu_)
  kLockRankRingComp = 72,     // RingListener::comp_mu_
  kLockRankRingBuf = 74,      // RingListener::buf_mu_
  kLockRankStatsSpan = 76,    // g_span_drain_mu: span-ring drain (its
                              // dropped-span accounting can enter the
                              // cell registry: span < cell)
  kLockRankChanReg = 77,      // g_chan_reg_mu: open-channel registry for
                              // the builtin.stats snapshot (near-leaf:
                              // the walk reads channel atomics only; the
                              // register/unregister sites hold no lock)
  kLockRankStatsCell = 78,    // g_cell_mu: stat-cell registry
  kLockRankTimerStart = 80,   // TimerThread::start_mu_
  kLockRankTimerBucket = 82,  // TimerThread::Bucket::bucket_mu
  kLockRankTimerCancel = 84,  // TimerThread::cancel_mu_
  // 86: timer.run (raw, cv partner)
  kLockRankSchedHooks = 88,   // Scheduler::hooks_mu_
  // 90: butex (raw, cv partner)
  kLockRankSchedRemote = 92,  // Worker::remote_mu
  kLockRankBulkPool = 93,     // iobuf bulk-slab freelist (read-side
                              // arena blocks for bulk frames): leaf
  // 94: sched.park (raw, cv partner)
  kLockRankBlockPool = 95,    // iobuf central block pool (batch steal/
                              // return under ANY runtime lock: leaf)
  kLockRankStackPool = 96,    // g_stack_pool_mu, innermost
};

#if defined(NAT_LOCKRANK)
namespace lockrank {
// Blocking acquisition about to happen: assert rank > deepest held,
// then push. Called BEFORE the underlying lock so an actual inversion
// aborts with a report instead of deadlocking silently.
void note_acquire(int rank);
// Successful try_lock: push without the order assert (non-blocking
// acquisitions cannot deadlock; brpc's try_lock-out-of-rank idiom).
void note_acquired(int rank);
void note_release(int rank);
// Fiber-switch hook (scheduler.cpp): no NatMutex may be held across a
// context switch — the fiber can resume on another thread while this
// thread's TLS still claims the rank.
void assert_none_held(const char* where);
}  // namespace lockrank
#endif

// Contended-acquisition slow path (defined in nat_prof.cpp): measures
// the blocking wait, feeds the always-on per-rank wait totals, and —
// when the contention profiler is armed — threshold/rate-samples a
// frame-pointer stack weighted by the wait into the per-thread rings
// surfaced at /hotspots/contention. MUST acquire no NatMutex itself (it
// runs inside an acquisition of arbitrary rank).
void nat_mu_contended_wait(std::mutex* m, int rank);

// Drop-in std::mutex wrapper carrying its declared rank. Zero overhead
// unless NAT_LOCKRANK is defined. Use with CTAD guards:
//   NatMutex<kLockRankSockEpoll> epollctl_mu;
//   std::lock_guard g(epollctl_mu);
template <int Rank>
class NatMutex {
 public:
  static constexpr int kRank = Rank;

  void lock() {
#if defined(NAT_LOCKRANK)
    lockrank::note_acquire(Rank);
#endif
    // uncontended fast path: one CAS, exactly what m_.lock() would do.
    // A failed try_lock IS contention — the out-of-line slow path
    // blocks in m_.lock() with the wait measured (the lock behavior
    // lockorder/dsched prove safe, finally measured for cost).
    if (m_.try_lock()) return;
    nat_mu_contended_wait(&m_, Rank);
  }

  bool try_lock() {
    if (!m_.try_lock()) return false;
#if defined(NAT_LOCKRANK)
    lockrank::note_acquired(Rank);
#endif
    return true;
  }

  void unlock() {
    m_.unlock();
#if defined(NAT_LOCKRANK)
    lockrank::note_release(Rank);
#endif
  }

 private:
  // natcheck:allow(lock-undeclared): NatMutex's own backing mutex — the
  // rank lives in the template parameter of each declaration site
  std::mutex m_;
};

}  // namespace brpc_tpu
