// nat_prof — SIGPROF-driven stack sampler. Design map in nat_prof.h.
//
// Data path: signal handler (any thread the kernel picks as "running on
// CPU") -> per-tid ProfCell claimed by CAS from a fixed pool -> seqlock
// sample slots (the span-ring discipline: busy mark, payload, publish)
// -> collector drains into an aggregated stack->count map under the
// report mutex -> flat / collapsed text reports.
#include "nat_prof.h"

#include <cxxabi.h>
#include <dlfcn.h>
#include <signal.h>
#include <string.h>
#include <sys/syscall.h>
#include <sys/time.h>
#include <sys/uio.h>
#include <ucontext.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <map>
#include <string>
#include <thread>
#include <vector>

#include "nat_api.h"
#include "nat_lockrank.h"
#include "nat_res.h"
#include "nat_stats.h"

namespace brpc_tpu {
namespace {

struct ProfSample {
  std::atomic<uint64_t> seq{0};  // 2t+1 = busy, 2t+2 = published
  uint32_t depth;
  uintptr_t pc[kProfMaxFrames];
};

struct ProfCell {
  std::atomic<int32_t> tid{0};     // 0 = free; CAS-claimed by the handler
  std::atomic<uint64_t> head{0};   // next ticket (handler-only writer)
  uint64_t next_read = 0;          // collector cursor (under report mu)
  ProfSample ring[kProfRing];
};

// fixed pool, zero-initialized BSS: the handler may claim but never
// allocates (cells persist across start/stop; a thread keeps its cell)
ProfCell g_cells[kProfCells];

std::atomic<bool> g_on{false};
std::atomic<uint64_t> g_samples{0};   // samples captured
std::atomic<uint64_t> g_dropped{0};   // cell pool exhausted / unwind empty
bool g_handler_installed = false;     // installed ONCE, never restored:
// a SIGPROF generated just before setitimer(0) can be DELIVERED after a
// handler restore, and the default SIGPROF action terminates the
// process — so stop() only disarms the timer and flips g_on; the
// installed handler is a no-op while off (the gperftools discipline)
// background collector: drains the bounded per-thread rings into the
// aggregate while sampling runs, so a minutes-long profile window does
// not overwrite its own early samples (rings hold kProfRing each).
// Heap-held + joined in stop — never a static std::thread (the
// static-dtor exit-crash class).
std::thread* g_collector = nullptr;
std::atomic<bool> g_collector_stop{false};

// control-path serialization: two concurrent /hotspots/native requests
// must not both win start (double collector spawn / mid-window stop)
NatMutex<kLockRankProfCtl> g_ctl_mu;
// aggregate since start/reset: leaf-first pc stack -> sample count
// (collector-side only, under g_report_mu)
NatMutex<kLockRankProfReport> g_report_mu;
std::map<std::vector<uintptr_t>, uint64_t>& g_stacks =
    *new std::map<std::vector<uintptr_t>, uint64_t>();  // natcheck:leak(g_stacks): collector drains at exit

// ---------------------------------------------------------------------------
// signal side — async-signal-safe only (natcheck sigsafe rule)
// ---------------------------------------------------------------------------

// Probe-read two frame words via process_vm_readv on ourselves: a raw
// syscall (async-signal-safe) that validates readability instead of
// faulting on a garbage frame pointer mid-prologue.
bool prof_safe_read(uintptr_t addr, uintptr_t out[2]) {
  struct iovec lio;
  lio.iov_base = out;
  lio.iov_len = 2 * sizeof(uintptr_t);
  struct iovec rio;
  rio.iov_base = (void*)addr;
  rio.iov_len = 2 * sizeof(uintptr_t);
  return syscall(SYS_process_vm_readv, (pid_t)syscall(SYS_getpid), &lio, 1,
                 &rio, 1, 0) == (ssize_t)(2 * sizeof(uintptr_t));
}

// Frame-pointer unwind from the interrupted context: [fp] = caller fp,
// [fp + 8] = return address (x86_64 / aarch64 frame records; the build
// keeps frame pointers). Bounded, monotone, probe-read — a corrupt
// chain terminates the walk, never the process.
int prof_unwind(void* ucv, uintptr_t* out) {
  uintptr_t pc = 0, fp = 0;
#if defined(__x86_64__)
  ucontext_t* uc = (ucontext_t*)ucv;
  pc = (uintptr_t)uc->uc_mcontext.gregs[REG_RIP];
  fp = (uintptr_t)uc->uc_mcontext.gregs[REG_RBP];
#elif defined(__aarch64__)
  ucontext_t* uc = (ucontext_t*)ucv;
  pc = (uintptr_t)uc->uc_mcontext.pc;
  fp = (uintptr_t)uc->uc_mcontext.regs[29];
#else
  (void)ucv;
  fp = (uintptr_t)__builtin_frame_address(0);
#endif
  int n = 0;
  if (pc != 0) out[n++] = pc;
  int hops = 0;
  while (n < kProfMaxFrames && fp != 0 &&
         (fp & (sizeof(uintptr_t) - 1)) == 0 && hops++ < 64) {
    uintptr_t frame[2];
    if (!prof_safe_read(fp, frame)) break;
    if (frame[1] < 4096) break;  // return address in the zero page: junk
    out[n++] = frame[1];
    // stacks grow down: the caller's frame is strictly above, and a sane
    // frame step is bounded (a giant jump means the chain left the stack)
    if (frame[0] <= fp || frame[0] - fp > (1u << 20)) break;
    fp = frame[0];
  }
  return n;
}

// (claim_cell lives in nat_prof.h now: the nat_res allocation ring is
// the third user of the fixed-pool CAS-claim discipline.)

ProfCell* prof_cell(int32_t tid) { return claim_cell(g_cells, tid); }

// The SIGPROF handler. natcheck:sigsafe — only syscalls, lock-free
// atomics and memcpy into preallocated rings are legal in this function
// (tools/natcheck lint `sigsafe` rule scans *_sighandler bodies).
void prof_sighandler(int, siginfo_t*, void* ucv) {
  int saved_errno = errno;  // syscalls below clobber it
  if (g_on.load(std::memory_order_relaxed)) {
    uintptr_t pcs[kProfMaxFrames];
    int depth = prof_unwind(ucv, pcs);
    if (depth <= 0) {
      g_dropped.fetch_add(1, std::memory_order_relaxed);
    } else {
      ProfCell* cell = prof_cell((int32_t)syscall(SYS_gettid));
      if (cell == nullptr) {
        g_dropped.fetch_add(1, std::memory_order_relaxed);
      } else {
        uint64_t t = cell->head.load(std::memory_order_relaxed);
        ProfSample& s = cell->ring[t & (kProfRing - 1)];
        s.seq.store(2 * t + 1, std::memory_order_relaxed);  // busy
        // payload stores must not become visible before the busy mark
        // (the span-ring seqlock discipline, nat_stats.cpp)
        std::atomic_thread_fence(std::memory_order_seq_cst);
        s.depth = (uint32_t)depth;
        memcpy(s.pc, pcs, (size_t)depth * sizeof(uintptr_t));
        s.seq.store(2 * t + 2, std::memory_order_release);   // published
        cell->head.store(t + 1, std::memory_order_release);
        g_samples.fetch_add(1, std::memory_order_relaxed);
      }
    }
  }
  errno = saved_errno;
}

// ---------------------------------------------------------------------------
// collector side — normal code, runs outside signal context
// ---------------------------------------------------------------------------

// Drain published samples from every cell into the aggregate map.
// Requires g_report_mu.
void prof_drain_locked() {
  for (int i = 0; i < kProfCells; i++) {
    ProfCell* c = &g_cells[i];
    if (c->tid.load(std::memory_order_acquire) == 0) continue;
    uint64_t head = c->head.load(std::memory_order_acquire);
    if (head - c->next_read > kProfRing) {
      // overwritten before this drain: account and skip forward
      g_dropped.fetch_add(head - c->next_read - kProfRing,
                          std::memory_order_relaxed);
      c->next_read = head - kProfRing;
    }
    std::vector<uintptr_t> stack;
    while (c->next_read < head) {
      ProfSample& s = c->ring[c->next_read & (kProfRing - 1)];
      uint64_t want = 2 * c->next_read + 2;
      bool kept = false;
      if (s.seq.load(std::memory_order_acquire) == want) {
        uint32_t depth = s.depth;
        if (depth > (uint32_t)kProfMaxFrames) depth = kProfMaxFrames;
        stack.assign(s.pc, s.pc + depth);
        // the copy must complete before the validation re-load (seqlock
        // reader recipe — the handler may be overwriting concurrently)
        std::atomic_thread_fence(std::memory_order_acquire);
        if (s.seq.load(std::memory_order_relaxed) == want) {
          g_stacks[stack] += 1;
          kept = true;
        }
      }
      // torn/overwritten mid-copy: every claimed ticket < head was
      // published once, so a mismatch IS a lost sample — account it
      // (the report's dropped figure must not undercount)
      if (!kept) g_dropped.fetch_add(1, std::memory_order_relaxed);
      c->next_read++;
    }
  }
}

// Collector loop: periodic ring drain while sampling runs (started by
// nat_prof_start, joined by nat_prof_stop).
void prof_collector_loop() {
  while (!g_collector_stop.load(std::memory_order_acquire)) {
    {
      std::lock_guard g(g_report_mu);
      prof_drain_locked();
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(250));
  }
}

// pc -> "symbol" via dladdr (cached); demangled when possible, else
// "module+0xoff" so JIT/unknown regions still aggregate stably.
std::string prof_symbolize(uintptr_t pc,
                           std::map<uintptr_t, std::string>* cache) {
  auto it = cache->find(pc);
  if (it != cache->end()) return it->second;
  std::string name;
  Dl_info info;
  // the RETURN address points one past the call site: resolve pc-1 so a
  // call ending a function does not symbolize as its successor
  if (dladdr((void*)(pc - 1), &info) != 0 && info.dli_sname != nullptr) {
    int status = 0;
    char* dem = abi::__cxa_demangle(info.dli_sname, nullptr, nullptr,
                                    &status);
    if (status == 0 && dem != nullptr) {
      name = dem;
      // strip template/arg noise for the flat table's readability
      size_t lt = name.find('<');
      size_t par = name.find('(');
      size_t cut = lt < par ? lt : par;
      if (cut != std::string::npos && cut > 0) name.resize(cut);
    } else {
      name = info.dli_sname;
    }
    free(dem);
  } else if (dladdr((void*)(pc - 1), &info) != 0 &&
             info.dli_fname != nullptr) {
    const char* base = strrchr(info.dli_fname, '/');
    char buf[160];
    snprintf(buf, sizeof(buf), "%s+0x%zx",
             base != nullptr ? base + 1 : info.dli_fname,
             (size_t)(pc - (uintptr_t)info.dli_fbase));
    name = buf;
  } else {
    char buf[32];
    snprintf(buf, sizeof(buf), "0x%zx", (size_t)pc);
    name = buf;
  }
  (*cache)[pc] = name;
  return name;
}

}  // namespace

// The one symbolizer (shared with nat_res's heap/growth reports).
std::string nat_prof_symbolize_pc(uintptr_t pc,
                                  std::map<uintptr_t, std::string>* cache) {
  return prof_symbolize(pc, cache);
}

// ---------------------------------------------------------------------------
// lock-contention profiler (/hotspots/contention's native half): the
// NatMutex<Rank> slow path lands here on every acquisition whose
// try_lock failed. Always-on: per-rank wait totals (two relaxed RMWs on
// a path that just blocked in a futex anyway). Armed via
// nat_mu_prof_start: waits past the threshold are rate-decimated
// (seeded, deterministic per thread) and a frame-pointer stack — leaf =
// a synthesized "lock:<rank name>" frame naming the contended NatMutex
// site — goes into per-tid seqlock rings, aggregated into collapsed
// stacks weighted by wait-us. No lock is ever taken on the record path
// (it runs INSIDE an acquisition of arbitrary rank).
// ---------------------------------------------------------------------------

namespace {

inline constexpr int kMuMaxRank = 128;
// synthesized leaf pc marking the contended lock's rank (real return
// addresses never live in this canonical-address hole)
inline constexpr uintptr_t kMuRankTag = (uintptr_t)0x00C0u << 48;

std::atomic<uint64_t> g_mu_rank_waits[kMuMaxRank];
std::atomic<uint64_t> g_mu_rank_wait_ns[kMuMaxRank];

std::atomic<bool> g_mu_on{false};
std::atomic<uint64_t> g_mu_threshold_ns{0};
std::atomic<uint32_t> g_mu_every{1};
std::atomic<uint64_t> g_mu_seed{0};
std::atomic<uint64_t> g_mu_samples{0};
std::atomic<uint64_t> g_mu_dropped{0};

struct MuSample {
  std::atomic<uint64_t> seq{0};  // 2t+1 = busy, 2t+2 = published
  uint64_t wait_ns;
  uint32_t depth;
  uintptr_t pc[kProfMaxFrames];
};

struct MuCell {
  std::atomic<int32_t> tid{0};   // 0 = free; CAS-claimed
  std::atomic<uint64_t> head{0};
  uint64_t next_read = 0;        // collector cursor (under g_mu_report_mu)
  MuSample ring[kProfRing];
};

// fixed pool, zero-initialized BSS (the record path never allocates)
MuCell g_mu_cells[kProfCells];

// nat_mu_contend_selftest's burn mutex (a declared rank like any other,
// so the selftest exercises the exact production slow path)
NatMutex<kLockRankMuSelftest> g_mu_selftest_mu;

// control + aggregate serialization (start/stop/reset/report only — the
// record path is lock-free)
NatMutex<kLockRankMuProfReport> g_mu_report_mu;
// stack -> {wait_us, waits}
// natcheck:leak(g_mu_stacks): detached runtime threads may still record
// at exit
std::map<std::vector<uintptr_t>, std::pair<uint64_t, uint64_t>>&
    g_mu_stacks = *new std::map<std::vector<uintptr_t>,
                                std::pair<uint64_t, uint64_t>>();

// rank -> human name. Mirrors the nat_lockrank.h table (a compile-time
// check that every named constant exists; a rank added there without a
// row here reports as "rank<N>").
const char* mu_rank_name(int rank) {
  switch (rank) {
    case kLockRankMuSelftest: return "mu.selftest";
    case kLockRankDumpCtl: return "dump.ctl";
    case kLockRankProfCtl: return "prof.ctl";
    case kLockRankResReport: return "res.report";
    case kLockRankProfReport: return "prof.report";
    case kLockRankMuProfReport: return "muprof.report";
    case kLockRankShmProbe: return "shm.probe";
    case 15: return "shm.fence";
    case kLockRankShmReq: return "shm.req";
    case kLockRankShmResp: return "shm.resp";
    case kLockRankShmFabric: return "shm.fabric";
    case kLockRankCluster: return "cluster";
    case kLockRankRuntime: return "runtime";
    case kLockRankListen: return "disp.listen";
    case kLockRankDispClose: return "disp.close";
    case kLockRankReconnect: return "chan.reconnect";
    case kLockRankHttpSess: return "http.sess";
    case kLockRankH2Sess: return "h2.sess";
    case kLockRankRedisSess: return "redis.sess";
    case kLockRankRedisStore: return "redis.store";
    case kLockRankHttpCli: return "http.cli";
    case kLockRankH2Cli: return "h2.cli";
    case kLockRankSslSess: return "ssl.sess";
    case kLockRankBreaker: return "chan.breaker";
    case kLockRankChanGrow: return "chan.grow";
    case 57: return "server.py";
    case kLockRankShmInflight: return "shm.inflight";
    case kLockRankOverload: return "overload";
    case kLockRankSockAlloc: return "sock.alloc";
    case kLockRankSockEpoll: return "sock.epoll";
    case kLockRankRingRetry: return "ring.retry";
    case kLockRankRingFiles: return "ring.files";
    case kLockRankRingSq: return "ring.sq";
    case kLockRankRingSend: return "ring.send";
    case kLockRankRingComp: return "ring.comp";
    case kLockRankRingBuf: return "ring.buf";
    case kLockRankStatsSpan: return "stats.span";
    case kLockRankChanReg: return "chan.registry";
    case kLockRankStatsCell: return "stats.cell";
    case kLockRankTimerStart: return "timer.start";
    case kLockRankTimerBucket: return "timer.bucket";
    case kLockRankTimerCancel: return "timer.cancel";
    case 86: return "timer.run";
    case kLockRankSchedHooks: return "sched.hooks";
    case 90: return "butex";
    case kLockRankSchedRemote: return "sched.remote";
    case kLockRankBulkPool: return "iobuf.bulk";
    case 94: return "sched.park";
    case kLockRankBlockPool: return "iobuf.pool";
    case kLockRankStackPool: return "stack.pool";
    default: return nullptr;
  }
}

// Frame-pointer walk from the CURRENT frame (normal code, not signal
// context): return addresses starting at our caller. Probe-read bounded
// monotone, like prof_unwind.
int mu_backtrace(uintptr_t* out, int max) {
  int n = 0;
  uintptr_t fp = (uintptr_t)__builtin_frame_address(0);
  int hops = 0;
  while (n < max && fp != 0 && (fp & (sizeof(uintptr_t) - 1)) == 0 &&
         hops++ < 64) {
    uintptr_t frame[2];
    if (!prof_safe_read(fp, frame)) break;
    if (frame[1] < 4096) break;
    out[n++] = frame[1];
    if (frame[0] <= fp || frame[0] - fp > (1u << 20)) break;
    fp = frame[0];
  }
  return n;
}

MuCell* mu_cell(int32_t tid) { return claim_cell(g_mu_cells, tid); }

// fixed BSS sample pools, attributed once for the RSS reconciliation
// (/status nat_mem line): resident the moment the first sample touches
// their pages
const bool g_prof_pools_registered = [] {
  NAT_RES_STATIC(NR_PROF_CELLS, sizeof(g_cells) + sizeof(g_mu_cells));
  return true;
}();

// Drain published contention samples into the aggregate map. Requires
// g_mu_report_mu.
// no_sanitize: seqlock reader — the plain payload copy intentionally
// races a recorder wrapping the ring; the seq recheck discards the torn
// snapshot, which TSan cannot model (same as nat_span_submit).
__attribute__((no_sanitize("thread")))
void mu_drain_locked() {
  for (int i = 0; i < kProfCells; i++) {
    MuCell* c = &g_mu_cells[i];
    if (c->tid.load(std::memory_order_acquire) == 0) continue;
    uint64_t head = c->head.load(std::memory_order_acquire);
    if (head - c->next_read > kProfRing) {
      g_mu_dropped.fetch_add(head - c->next_read - kProfRing,
                             std::memory_order_relaxed);
      c->next_read = head - kProfRing;
    }
    std::vector<uintptr_t> stack;
    while (c->next_read < head) {
      MuSample& s = c->ring[c->next_read & (kProfRing - 1)];
      uint64_t want = 2 * c->next_read + 2;
      bool kept = false;
      if (s.seq.load(std::memory_order_acquire) == want) {
        uint32_t depth = s.depth;
        if (depth > (uint32_t)kProfMaxFrames) depth = kProfMaxFrames;
        uint64_t wait_ns = s.wait_ns;
        stack.assign(s.pc, s.pc + depth);
        // seqlock reader recipe: copy before the validating re-load
        std::atomic_thread_fence(std::memory_order_acquire);
        if (s.seq.load(std::memory_order_relaxed) == want) {
          uint64_t us = wait_ns / 1000;
          auto& agg = g_mu_stacks[stack];
          agg.first += us > 0 ? us : 1;  // sub-us waits still visible
          agg.second += 1;
          kept = true;
        }
      }
      if (!kept) g_mu_dropped.fetch_add(1, std::memory_order_relaxed);
      c->next_read++;
    }
  }
}

// pc -> symbol for the contention report: the synthesized rank-tag leaf
// names the contended NatMutex site; real pcs go through prof_symbolize.
std::string mu_symbolize(uintptr_t pc,
                         std::map<uintptr_t, std::string>* cache) {
  if ((pc & ~(uintptr_t)0xffff) == kMuRankTag) {
    int rank = (int)(pc & 0xffff);
    const char* nm = mu_rank_name(rank);
    char buf[48];
    if (nm != nullptr) {
      snprintf(buf, sizeof(buf), "lock:%s<%d>", nm, rank);
    } else {
      snprintf(buf, sizeof(buf), "lock:rank<%d>", rank);
    }
    return buf;
  }
  return prof_symbolize(pc, cache);
}

}  // namespace

// Shared frame-pointer walk for samplers running in NORMAL code (the
// contention profiler here and nat_res's allocation-site sampler):
// return addresses starting at this function's caller.
int nat_fp_backtrace(uintptr_t* out, int max) {
  return mu_backtrace(out, max);
}

// no_sanitize: seqlock writer — see mu_drain_locked. Only the ring
// publish is annotated; the enclosing wait path keeps instrumentation
// (it performs the real mutex acquisition).
__attribute__((no_sanitize("thread")))
static void mu_ring_publish(MuCell* cell, uint64_t wait_ns,
                            const uintptr_t* pcs, int depth) {
  uint64_t t = cell->head.load(std::memory_order_relaxed);
  MuSample& s = cell->ring[t & (kProfRing - 1)];
  s.seq.store(2 * t + 1, std::memory_order_relaxed);  // busy
  // payload stores must not become visible before the busy mark (the
  // span-ring seqlock discipline)
  std::atomic_thread_fence(std::memory_order_seq_cst);
  s.wait_ns = wait_ns;
  s.depth = (uint32_t)depth;
  memcpy(s.pc, pcs, (size_t)depth * sizeof(uintptr_t));
  s.seq.store(2 * t + 2, std::memory_order_release);  // published
  cell->head.store(t + 1, std::memory_order_release);
  g_mu_samples.fetch_add(1, std::memory_order_relaxed);
}

void nat_mu_contended_wait(std::mutex* m, int rank) {
  uint64_t t0 = nat_now_ns();
  m->lock();
  uint64_t wait_ns = nat_now_ns() - t0;
  int r = (rank >= 0 && rank < kMuMaxRank) ? rank : 0;
  // always-on per-rank totals: this path just blocked in a futex — two
  // relaxed RMWs are free by comparison (and gone when uncontended)
  g_mu_rank_waits[r].fetch_add(1, std::memory_order_relaxed);
  g_mu_rank_wait_ns[r].fetch_add(wait_ns, std::memory_order_relaxed);
  if (!g_mu_on.load(std::memory_order_relaxed)) return;
  if (wait_ns < g_mu_threshold_ns.load(std::memory_order_relaxed)) return;
  uint32_t every = g_mu_every.load(std::memory_order_relaxed);
  if (every > 1) {
    // seeded decimation: deterministic per thread for a given seed (the
    // natfault decision discipline — replayable, not modulo-phased)
    static thread_local uint64_t n = 0;
    if (nat_mix64(g_mu_seed.load(std::memory_order_relaxed) ^ ++n) %
            every !=
        0) {
      return;
    }
  }
  // capture AFTER the acquisition: we hold the lock for the ~us the walk
  // takes (the gperftools contention-profiler tradeoff; sampling keeps
  // it off most contended acquisitions)
  uintptr_t pcs[kProfMaxFrames];
  pcs[0] = kMuRankTag | (uintptr_t)(uint16_t)r;
  int depth = 1 + mu_backtrace(pcs + 1, kProfMaxFrames - 1);
  MuCell* cell = mu_cell((int32_t)syscall(SYS_gettid));
  if (cell == nullptr) {
    g_mu_dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  mu_ring_publish(cell, wait_ns, pcs, depth);
}

}  // namespace brpc_tpu

using namespace brpc_tpu;

extern "C" {

// Start sampling at `hz` (<= 0 -> 99). SIGPROF fires on process CPU
// time, so idle threads cost nothing and busy ones are sampled in
// proportion to the cycles they burn. Returns 0, -1 when already
// running, -2 when the handler/timer could not be installed.
int nat_prof_start(int hz) {
  // serialize the whole control op: a concurrent start must lose with -1
  // (not spawn a second collector), and a start racing a stop must see
  // a fully-torn-down profiler
  std::lock_guard ctl(g_ctl_mu);
  if (g_on.load(std::memory_order_acquire)) return -1;
  if (hz <= 0) hz = 99;
  if (hz > 1000) hz = 1000;
  if (!g_handler_installed) {
    struct sigaction sa;
    memset(&sa, 0, sizeof(sa));
    sa.sa_sigaction = prof_sighandler;
    sa.sa_flags = SA_SIGINFO | SA_RESTART;
    sigemptyset(&sa.sa_mask);
    if (sigaction(SIGPROF, &sa, nullptr) != 0) return -2;
    g_handler_installed = true;
  }
  // reclaim cells whose threads are gone (no handler can run: g_on is
  // false and the ctl mutex is held) — a churny embedder would otherwise
  // exhaust the fixed pool across profiling windows
  {
    std::lock_guard g(g_report_mu);
    prof_drain_locked();  // keep any still-undrained samples
    for (int i = 0; i < kProfCells; i++) {
      int32_t tid = g_cells[i].tid.load(std::memory_order_acquire);
      if (tid == 0) continue;
      char path[64];
      snprintf(path, sizeof(path), "/proc/self/task/%d", tid);
      if (access(path, F_OK) != 0) {
        g_cells[i].next_read =
            g_cells[i].head.load(std::memory_order_acquire);
        g_cells[i].tid.store(0, std::memory_order_release);
      }
    }
  }
  g_on.store(true, std::memory_order_release);
  struct itimerval it;
  it.it_interval.tv_sec = hz == 1 ? 1 : 0;
  it.it_interval.tv_usec = hz == 1 ? 0 : 1000000 / hz;
  it.it_value = it.it_interval;
  if (setitimer(ITIMER_PROF, &it, nullptr) != 0) {
    g_on.store(false, std::memory_order_release);
    return -2;
  }
  g_collector_stop.store(false, std::memory_order_release);
  // natcheck:allow(resacct): control-plane thread handle, joined in stop
  g_collector = new std::thread(prof_collector_loop);
  return 0;
}

// Stop sampling (samples stay drainable for nat_prof_report). Safe to
// call when not running.
int nat_prof_stop(void) {
  std::lock_guard ctl(g_ctl_mu);
  if (!g_on.exchange(false, std::memory_order_acq_rel)) return 0;
  struct itimerval off;
  memset(&off, 0, sizeof(off));
  setitimer(ITIMER_PROF, &off, nullptr);
  // the handler stays installed (no-op while g_on is false): restoring
  // the previous disposition here could hand a still-pending SIGPROF to
  // the DEFAULT action, which terminates the process
  if (g_collector != nullptr) {
    g_collector_stop.store(true, std::memory_order_release);
    // natcheck:allow(lock-switch): control path on embedder threads
    // (never a fiber); g_ctl_mu is held ON PURPOSE so a concurrent
    // start cannot spawn a second collector while this one is joining
    g_collector->join();
    delete g_collector;
    g_collector = nullptr;
  }
  return 0;
}

int nat_prof_running(void) {
  return g_on.load(std::memory_order_acquire) ? 1 : 0;
}

uint64_t nat_prof_samples(void) {
  return g_samples.load(std::memory_order_relaxed);
}

// Forget everything sampled so far (aggregate + undrained ring content).
void nat_prof_reset(void) {
  std::lock_guard g(g_report_mu);
  for (int i = 0; i < kProfCells; i++) {
    g_cells[i].next_read = g_cells[i].head.load(std::memory_order_acquire);
  }
  g_stacks.clear();
  g_samples.store(0, std::memory_order_relaxed);
  g_dropped.store(0, std::memory_order_relaxed);
}

// Render the profile accumulated since start/reset. mode 0 = flat
// self-sample symbol table (the PROFILE_r*.md shape), mode 1 = collapsed
// stacks (root;...;leaf count — flamegraph.pl / speedscope compatible).
// *out is malloc'd (free with nat_buf_free); returns 0, -1 on OOM.
int nat_prof_report(int mode, char** out, size_t* out_len) {
  if (out == nullptr || out_len == nullptr) return -1;
  std::string text;
  {
    std::lock_guard g(g_report_mu);
    prof_drain_locked();
    std::map<uintptr_t, std::string> symcache;
    uint64_t total = 0;
    for (const auto& kv : g_stacks) total += kv.second;
    char hdr[160];
    snprintf(hdr, sizeof(hdr),
             "# nat_prof: %llu samples (%llu dropped), %s\n",
             (unsigned long long)total,
             (unsigned long long)g_dropped.load(std::memory_order_relaxed),
             mode == 0 ? "flat self samples"
                       : "collapsed stacks (root..leaf count)");
    text += hdr;
    if (mode == 0) {
      // flat: self samples per leaf symbol, descending
      std::map<std::string, uint64_t> flat;
      for (const auto& kv : g_stacks) {
        flat[prof_symbolize(kv.first.front(), &symcache)] += kv.second;
      }
      std::vector<std::pair<uint64_t, const std::string*>> rows;
      rows.reserve(flat.size());
      for (const auto& kv : flat) rows.emplace_back(kv.second, &kv.first);
      std::sort(rows.begin(), rows.end(),
                [](const auto& a, const auto& b) { return a.first > b.first; });
      for (const auto& r : rows) {
        char line[256];
        snprintf(line, sizeof(line), "%8llu %5.1f%%  %s\n",
                 (unsigned long long)r.first,
                 total != 0 ? 100.0 * (double)r.first / (double)total : 0.0,
                 r.second->c_str());
        text += line;
      }
    } else {
      // collapsed: samples are leaf-first; flamegraph wants root..leaf
      std::map<std::string, uint64_t> folded;
      std::string key;
      for (const auto& kv : g_stacks) {
        key.clear();
        for (size_t i = kv.first.size(); i-- > 0;) {
          if (!key.empty()) key += ';';
          key += prof_symbolize(kv.first[i], &symcache);
        }
        folded[key] += kv.second;
      }
      for (const auto& kv : folded) {
        text += kv.first;
        char cnt[32];
        snprintf(cnt, sizeof(cnt), " %llu\n",
                 (unsigned long long)kv.second);
        text += cnt;
      }
    }
  }
  // natcheck:allow(resacct): FFI report buffer, freed by the caller
  char* buf = (char*)malloc(text.size() + 1);
  if (buf == nullptr) return -1;
  memcpy(buf, text.data(), text.size());
  buf[text.size()] = '\0';
  *out = buf;
  *out_len = text.size();
  return 0;
}

// ---------------------------------------------------------------------------
// contention-profiler control surface (the /hotspots/contention backend)
// ---------------------------------------------------------------------------

// Arm stack sampling of contended NatMutex acquisitions: waits of at
// least `threshold_us` are sampled (0 = all), decimated to one in
// `every` (<= 1 = all) with a seeded deterministic decision. Returns 0,
// -1 when already running.
int nat_mu_prof_start(int threshold_us, int every, uint64_t seed) {
  std::lock_guard g(g_mu_report_mu);
  if (g_mu_on.load(std::memory_order_acquire)) return -1;
  g_mu_threshold_ns.store(
      threshold_us > 0 ? (uint64_t)threshold_us * 1000ull : 0,
      std::memory_order_relaxed);
  g_mu_every.store(every > 1 ? (uint32_t)every : 1,
                   std::memory_order_relaxed);
  g_mu_seed.store(seed, std::memory_order_relaxed);
  g_mu_on.store(true, std::memory_order_release);
  return 0;
}

// Stop sampling and fold the rings into the aggregate (samples stay
// reportable). Safe when not running.
int nat_mu_prof_stop(void) {
  std::lock_guard g(g_mu_report_mu);
  g_mu_on.store(false, std::memory_order_release);
  mu_drain_locked();
  return 0;
}

int nat_mu_prof_running(void) {
  return g_mu_on.load(std::memory_order_acquire) ? 1 : 0;
}

uint64_t nat_mu_prof_samples(void) {
  return g_mu_samples.load(std::memory_order_relaxed);
}

// Forget the sampled stacks (aggregate + undrained rings) but keep the
// always-on per-rank totals: those are exported as monotonic counters
// (/brpc_metrics nat_lock_contention_*), and a debug-page request must
// not reset an operator's rate() series.
void nat_mu_prof_reset_samples(void) {
  std::lock_guard g(g_mu_report_mu);
  for (int i = 0; i < kProfCells; i++) {
    g_mu_cells[i].next_read =
        g_mu_cells[i].head.load(std::memory_order_acquire);
  }
  g_mu_stacks.clear();
  g_mu_samples.store(0, std::memory_order_relaxed);
  g_mu_dropped.store(0, std::memory_order_relaxed);
}

// Forget everything sampled so far (aggregate + undrained rings + the
// always-on per-rank totals — test/bench hygiene).
void nat_mu_prof_reset(void) {
  nat_mu_prof_reset_samples();
  for (int r = 0; r < kMuMaxRank; r++) {
    g_mu_rank_waits[r].store(0, std::memory_order_relaxed);
    g_mu_rank_wait_ns[r].store(0, std::memory_order_relaxed);
  }
}

// Render the contention profile. mode 0 = flat wait-us per contended
// lock site (the leaf "lock:<name>" frames), mode 1 = collapsed stacks
// weighted by wait-us (flamegraph/speedscope). *out malloc'd (free with
// nat_buf_free); 0 ok, -1 OOM.
int nat_mu_prof_report(int mode, char** out, size_t* out_len) {
  if (out == nullptr || out_len == nullptr) return -1;
  std::string text;
  {
    std::lock_guard g(g_mu_report_mu);
    mu_drain_locked();
    std::map<uintptr_t, std::string> symcache;
    uint64_t total_us = 0, total_n = 0;
    for (const auto& kv : g_mu_stacks) {
      total_us += kv.second.first;
      total_n += kv.second.second;
    }
    char hdr[192];
    snprintf(hdr, sizeof(hdr),
             "# nat_mu_prof: %llu contended waits sampled, %llu us total "
             "(%llu dropped), %s\n",
             (unsigned long long)total_n, (unsigned long long)total_us,
             (unsigned long long)g_mu_dropped.load(
                 std::memory_order_relaxed),
             mode == 0 ? "flat wait-us by lock site"
                       : "collapsed stacks weighted by wait-us");
    text += hdr;
    if (mode == 0) {
      // flat: wait-us per contended lock (the synthesized leaf frame)
      std::map<std::string, std::pair<uint64_t, uint64_t>> flat;
      for (const auto& kv : g_mu_stacks) {
        auto& f = flat[mu_symbolize(kv.first.front(), &symcache)];
        f.first += kv.second.first;
        f.second += kv.second.second;
      }
      std::vector<std::pair<uint64_t, const std::string*>> rows;
      std::map<const std::string*, uint64_t> counts;
      rows.reserve(flat.size());
      for (const auto& kv : flat) {
        rows.emplace_back(kv.second.first, &kv.first);
        counts[&kv.first] = kv.second.second;
      }
      std::sort(rows.begin(), rows.end(),
                [](const auto& a, const auto& b) { return a.first > b.first; });
      for (const auto& r : rows) {
        char line[256];
        snprintf(line, sizeof(line), "%10llu us %5.1f%% %8llu waits  %s\n",
                 (unsigned long long)r.first,
                 total_us != 0 ? 100.0 * (double)r.first / (double)total_us
                               : 0.0,
                 (unsigned long long)counts[r.second], r.second->c_str());
        text += line;
      }
    } else {
      // collapsed: samples are leaf-first; emit root..leaf with wait-us
      std::map<std::string, uint64_t> folded;
      std::string key;
      for (const auto& kv : g_mu_stacks) {
        key.clear();
        for (size_t i = kv.first.size(); i-- > 0;) {
          if (!key.empty()) key += ';';
          key += mu_symbolize(kv.first[i], &symcache);
        }
        folded[key] += kv.second.first;
      }
      for (const auto& kv : folded) {
        text += kv.first;
        char cnt[32];
        snprintf(cnt, sizeof(cnt), " %llu\n",
                 (unsigned long long)kv.second);
        text += cnt;
      }
    }
  }
  // natcheck:allow(resacct): FFI report buffer, freed by the caller
  char* buf = (char*)malloc(text.size() + 1);
  if (buf == nullptr) return -1;
  memcpy(buf, text.data(), text.size());
  buf[text.size()] = '\0';
  *out = buf;
  *out_len = text.size();
  return 0;
}

// Always-on per-rank wait totals (independent of sampling): one row per
// rank that saw at least one contended acquisition. Returns rows
// written.
int nat_mu_rank_stats(brpc_tpu::NatLockRankRow* out, int max) {
  int n = 0;
  for (int r = 0; r < kMuMaxRank && n < max; r++) {
    uint64_t waits = g_mu_rank_waits[r].load(std::memory_order_relaxed);
    if (waits == 0) continue;
    NatLockRankRow& row = out[n++];
    row.waits = waits;
    row.wait_us =
        g_mu_rank_wait_ns[r].load(std::memory_order_relaxed) / 1000;
    row.rank = r;
    const char* nm = mu_rank_name(r);
    if (nm == nullptr) nm = "?";
    snprintf(row.name, sizeof(row.name), "%s", nm);
  }
  return n;
}

// Rank -> human name (nullptr for unnamed ranks). Exists so the Python
// drift test can assert every nat_lockrank.h constant has a
// mu_rank_name row — the switch is hand-mirrored from the header, and
// a rank added without a name would otherwise silently report as
// "rank<N>" in /hotspots/contention.
const char* nat_mu_rank_name(int rank) { return mu_rank_name(rank); }

// Deterministic contention generator for tests/smokes: `nthreads`
// threads fight over one NatMutex, holding it `hold_us` per iteration.
// Returns the selftest rank's contended-wait count afterwards — the
// caller can assert both the always-on totals and (when armed) that the
// sampled report attributes wait to "lock:mu.selftest".
uint64_t nat_mu_contend_selftest(int nthreads, int iters, int hold_us) {
  if (nthreads < 2) nthreads = 2;
  if (nthreads > 16) nthreads = 16;
  if (iters <= 0) iters = 50;
  if (hold_us <= 0) hold_us = 20;
  std::vector<std::thread> threads;
  threads.reserve((size_t)nthreads);
  // start barrier: without it, on a loaded small host each thread can
  // run its whole loop before the next is even scheduled — zero
  // contended waits, and every caller asserting waits > 0 flakes
  std::atomic<int> ready{0};
  for (int t = 0; t < nthreads; t++) {
    threads.emplace_back([iters, hold_us, nthreads, &ready] {
      ready.fetch_add(1, std::memory_order_acq_rel);
      while (ready.load(std::memory_order_acquire) < nthreads) {
      }
      for (int i = 0; i < iters; i++) {
        std::lock_guard g(g_mu_selftest_mu);
        uint64_t until = nat_now_ns() + (uint64_t)hold_us * 1000ull;
        while (nat_now_ns() < until) {
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  // Minimum-contention harness: the start barrier releases every thread
  // together, but a loaded 2-cpu host can still SERIALIZE them — each
  // thread runs its whole hold inside one scheduling quantum and every
  // try_lock succeeds, so the round ends with zero contended waits and
  // every caller asserting waits > 0 flakes. When that happens, force at
  // least one contended acquisition with a two-thread handshake: the
  // holder takes the mutex and keeps it until the waiter has ANNOUNCED
  // its lock() attempt, then holds through a widening window so the
  // waiter's try_lock lands inside the hold. Bounded retries with a
  // doubling window make a miss (waiter descheduled for the entire
  // window between announce and try_lock) vanishingly unlikely.
  uint64_t waits = g_mu_rank_waits[kLockRankMuSelftest].load(
      std::memory_order_relaxed);
  for (int round = 0; waits == 0 && round < 64; round++) {
    std::atomic<bool> held{false};
    std::atomic<bool> attempting{false};
    std::thread holder([&held, &attempting, hold_us, round] {
      std::lock_guard g(g_mu_selftest_mu);
      held.store(true, std::memory_order_release);
      uint64_t deadline = nat_now_ns() + 50'000'000ull;  // 50ms cap
      while (!attempting.load(std::memory_order_acquire) &&
             nat_now_ns() < deadline) {
      }
      uint64_t window =
          (uint64_t)hold_us * 1000ull * (1ull << (round < 10 ? round : 10));
      uint64_t until = nat_now_ns() + window;
      while (nat_now_ns() < until) {
      }
    });
    std::thread waiter([&held, &attempting] {
      uint64_t deadline = nat_now_ns() + 50'000'000ull;
      while (!held.load(std::memory_order_acquire) &&
             nat_now_ns() < deadline) {
      }
      attempting.store(true, std::memory_order_release);
      std::lock_guard g(g_mu_selftest_mu);
    });
    holder.join();
    waiter.join();
    waits = g_mu_rank_waits[kLockRankMuSelftest].load(
        std::memory_order_relaxed);
  }
  return waits;
}

}  // extern "C"
