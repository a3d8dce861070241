// nat_res — the native memory observatory. Design map in nat_res.h.
//
// Ledger data path: allocation seam (any thread, possibly under an
// allocator/registry lock) -> per-tid NatResCell claimed lock-free from
// a fixed BSS pool (the nat_prof claim_cell discipline) -> combined on
// demand into NatResRow snapshots; a per-subsystem global (live, hwm)
// atomic pair tracks the high-water mark the cells cannot compute.
//
// Profiler data path: armed seam -> frame-pointer unwind
// (nat_fp_backtrace) -> per-tid seqlock event rings (the mu-prof
// publish protocol, one writer per ring) -> drained under g_res_report_mu
// into a live-bytes-by-site map keyed by [subsystem-tag, stack...],
// with a ptr -> site address table so frees subtract from the site that
// allocated them. Events carry a global ticket so a cross-thread free
// applies after its alloc regardless of which ring drains first.
#include "nat_res.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <map>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "nat_api.h"
#include "nat_lockrank.h"
#include "nat_prof.h"
#include "nat_stats.h"

namespace brpc_tpu {
namespace {

// ---------------------------------------------------------------------------
// ledger — per-thread cells (fixed pool, lock-free claim) + global
// (live, hwm) pairs. The counters are relaxed fetch_adds, NOT the
// nat_stats single-writer store discipline: every seam is a pool-miss
// cold path (a real new/malloc/mmap), several run while HOLDING
// allocator locks (iobuf's central pool mutex, the socket registry
// mutex), and a registry mutex here would be a lock-rank inversion —
// so the cells exist to spread cache lines, not to avoid RMWs.
// ---------------------------------------------------------------------------

inline constexpr int kResCells = 256;

// TRIVIALLY default-constructible on purpose (no member initializers):
// other TUs' static initializers register their fixed pools through
// nat_res_alloc BEFORE this TU's dynamic initialization runs, so these
// cells must be pure zero-init BSS — a `tid{0}` initializer would make
// the ctor non-constexpr, emit a dynamic initializer, and silently
// un-claim (tid = 0) the cells those early registrations wrote.
struct NatResCell {
  std::atomic<int32_t> tid;  // 0 (zero-init) = free; CAS-claimed
  std::atomic<uint64_t> alloc_bytes[NR_SUBSYS_COUNT];
  std::atomic<uint64_t> free_bytes[NR_SUBSYS_COUNT];
  std::atomic<uint64_t> allocs[NR_SUBSYS_COUNT];
  std::atomic<uint64_t> frees[NR_SUBSYS_COUNT];
};

// fixed pool, zero-initialized BSS; cells persist for the process (an
// exited thread's cumulative counts keep contributing, and its cell is
// re-claimed when the kernel reuses the tid)
NatResCell g_res_cells[kResCells];
// pool exhausted (thread #257+): shared spill cell — fetch_adds stay
// correct, just contended
NatResCell g_res_overflow;

thread_local NatResCell* tls_res_cell = nullptr;

NatResCell* res_cell() {
  NatResCell* c = tls_res_cell;
  if (c != nullptr) return c;
  c = claim_cell(g_res_cells, (int32_t)syscall(SYS_gettid));
  if (c == nullptr) c = &g_res_overflow;
  tls_res_cell = c;
  return c;
}

// global per-subsystem live/hwm pairs — the high-water mark needs the
// combined live value at alloc time, which per-thread cells cannot give
std::atomic<int64_t> g_res_live_bytes[NR_SUBSYS_COUNT];
std::atomic<int64_t> g_res_hwm_bytes[NR_SUBSYS_COUNT];

const char* kResNames[NR_SUBSYS_COUNT] = {
    "iobuf.block", "iobuf.refs", "sock.slab",  "sock.wreq",
    "srv.pyreq",   "sched.stack", "shm.seg",   "shm.span",
    "dump.spill",  "prof.cells",  "cluster",    "stats.cell",
    "selftest",
};

void res_hwm_update(int sub, int64_t live) {
  int64_t hwm = g_res_hwm_bytes[sub].load(std::memory_order_relaxed);
  while (live > hwm && !g_res_hwm_bytes[sub].compare_exchange_weak(
                           hwm, live, std::memory_order_relaxed)) {
  }
}

// ---------------------------------------------------------------------------
// allocation-site profiler — armed seams publish alloc/free events into
// per-tid seqlock rings; the drain (under g_res_report_mu) applies them
// in global-ticket order to the site/address maps.
// ---------------------------------------------------------------------------

inline constexpr int kResMaxFrames = 16;
// synthesized leaf pc naming the subsystem (the mu-prof rank-tag
// discipline; this canonical-address hole never holds real code)
inline constexpr uintptr_t kResSubTag = (uintptr_t)0x00C1u << 48;

std::atomic<bool> g_res_on{false};
std::atomic<uint32_t> g_res_every{1};
std::atomic<uint64_t> g_res_seed{0};
std::atomic<uint64_t> g_res_samples{0};
std::atomic<uint64_t> g_res_dropped{0};
std::atomic<uint64_t> g_res_ticket{0};  // global event order

struct ResEvent {
  std::atomic<uint64_t> seq{0};  // 2t+1 = busy, 2t+2 = published
  uint64_t gseq;
  uint64_t bytes;
  uintptr_t ptr;
  int32_t sub;
  int32_t kind;  // 0 = alloc (carries a stack), 1 = free
  uint32_t depth;
  uintptr_t pc[kResMaxFrames];
};

struct ResRingCell {
  std::atomic<int32_t> tid{0};  // 0 = free; CAS-claimed
  std::atomic<uint64_t> head{0};
  uint64_t next_read = 0;  // collector cursor (under g_res_report_mu)
  ResEvent ring[kProfRing];
};

// fixed pool, zero-initialized BSS (the record path never allocates)
ResRingCell g_res_rings[kProfCells];

// control + aggregate serialization (drain/report/baseline only — the
// record path is lock-free)
NatMutex<kLockRankResReport> g_res_report_mu;

struct SiteAgg {
  uint64_t live_bytes = 0;
  uint64_t live_objs = 0;
  uint64_t cum_bytes = 0;
  uint64_t cum_allocs = 0;
};
using SiteMap = std::map<std::vector<uintptr_t>, SiteAgg>;
// natcheck:leak(g_res_sites): detached runtime threads may still record
// allocation events through exit()
SiteMap& g_res_sites = *new SiteMap();
struct PtrEnt {
  SiteMap::iterator site;
  uint64_t bytes;
};
// natcheck:leak(g_res_addrs): same lifetime as g_res_sites
std::unordered_map<uintptr_t, PtrEnt>& g_res_addrs =
    *new std::unordered_map<uintptr_t, PtrEnt>();
// /growth/native baseline: live-bytes-by-site at the last
// nat_res_growth_baseline (or prof_start) call
// natcheck:leak(g_res_baseline): same lifetime as g_res_sites
std::map<std::vector<uintptr_t>, uint64_t>& g_res_baseline =
    *new std::map<std::vector<uintptr_t>, uint64_t>();
bool g_res_baseline_taken = false;

// no_sanitize: seqlock writer — the plain payload stores intentionally
// race a drain wrapping the ring; the seq recheck discards the torn
// snapshot (the span-ring/mu-ring discipline, nat_stats.cpp).
__attribute__((no_sanitize("thread")))
void res_ring_publish(int kind, int sub, size_t bytes, void* ptr,
                      const uintptr_t* pcs, int depth) {
  ResRingCell* cell =
      claim_cell(g_res_rings, (int32_t)syscall(SYS_gettid));
  if (cell == nullptr) {
    g_res_dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  uint64_t t = cell->head.load(std::memory_order_relaxed);
  ResEvent& s = cell->ring[t & (kProfRing - 1)];
  s.seq.store(2 * t + 1, std::memory_order_relaxed);  // busy
  // payload stores must not become visible before the busy mark
  std::atomic_thread_fence(std::memory_order_seq_cst);
  s.gseq = g_res_ticket.fetch_add(1, std::memory_order_relaxed);
  s.bytes = bytes;
  s.ptr = (uintptr_t)ptr;
  s.sub = sub;
  s.kind = kind;
  s.depth = (uint32_t)depth;
  if (depth > 0) {
    memcpy(s.pc, pcs, (size_t)depth * sizeof(uintptr_t));
  }
  s.seq.store(2 * t + 2, std::memory_order_release);  // published
  cell->head.store(t + 1, std::memory_order_release);
  g_res_samples.fetch_add(1, std::memory_order_relaxed);
}

// Drain every ring into the site/address maps. Requires
// g_res_report_mu. Events are applied in global-ticket order so a free
// recorded on thread B lands AFTER the alloc recorded on thread A.
// no_sanitize: seqlock reader — see res_ring_publish.
__attribute__((no_sanitize("thread")))
void res_drain_locked() {
  struct Pending {
    uint64_t gseq;
    uint64_t bytes;
    uintptr_t ptr;
    int32_t sub;
    int32_t kind;
    uint32_t depth;
    uintptr_t pc[kResMaxFrames];
  };
  std::vector<Pending> events;
  for (auto& c : g_res_rings) {
    if (c.tid.load(std::memory_order_acquire) == 0) continue;
    uint64_t head = c.head.load(std::memory_order_acquire);
    if (head - c.next_read > kProfRing) {
      g_res_dropped.fetch_add(head - c.next_read - kProfRing,
                              std::memory_order_relaxed);
      c.next_read = head - kProfRing;
    }
    while (c.next_read < head) {
      ResEvent& s = c.ring[c.next_read & (kProfRing - 1)];
      uint64_t want = 2 * c.next_read + 2;
      bool kept = false;
      if (s.seq.load(std::memory_order_acquire) == want) {
        Pending p;
        p.gseq = s.gseq;
        p.bytes = s.bytes;
        p.ptr = s.ptr;
        p.sub = s.sub;
        p.kind = s.kind;
        p.depth = s.depth > (uint32_t)kResMaxFrames ? kResMaxFrames
                                                    : s.depth;
        memcpy(p.pc, s.pc, sizeof(p.pc));
        // the copy must complete before the validation re-load
        // (seqlock reader recipe)
        std::atomic_thread_fence(std::memory_order_acquire);
        if (s.seq.load(std::memory_order_relaxed) == want) {
          events.push_back(p);
          kept = true;
        }
      }
      if (!kept) g_res_dropped.fetch_add(1, std::memory_order_relaxed);
      c.next_read++;
    }
  }
  std::sort(events.begin(), events.end(),
            [](const Pending& a, const Pending& b) {
              return a.gseq < b.gseq;
            });
  std::vector<uintptr_t> stack;
  for (const Pending& p : events) {
    if (p.kind == 0) {
      stack.clear();
      stack.push_back(kResSubTag | (uintptr_t)(uint16_t)p.sub);
      stack.insert(stack.end(), p.pc, p.pc + p.depth);
      auto it = g_res_sites.emplace(stack, SiteAgg()).first;
      it->second.live_bytes += p.bytes;
      it->second.live_objs += 1;
      it->second.cum_bytes += p.bytes;
      it->second.cum_allocs += 1;
      auto old = g_res_addrs.find(p.ptr);
      if (old != g_res_addrs.end()) {
        // address reuse with the intervening free event lost (ring
        // overwrite): reconcile the stale entry so the old site does
        // not leak in the profile forever
        SiteAgg& agg = old->second.site->second;
        agg.live_bytes -= old->second.bytes < agg.live_bytes
                              ? old->second.bytes
                              : agg.live_bytes;
        if (agg.live_objs > 0) agg.live_objs -= 1;
        old->second = {it, p.bytes};
      } else {
        g_res_addrs.emplace(p.ptr, PtrEnt{it, p.bytes});
      }
    } else {
      auto ae = g_res_addrs.find(p.ptr);
      if (ae == g_res_addrs.end()) continue;  // unsampled / pre-arming
      SiteAgg& agg = ae->second.site->second;
      agg.live_bytes -= ae->second.bytes < agg.live_bytes
                            ? ae->second.bytes
                            : agg.live_bytes;
      if (agg.live_objs > 0) agg.live_objs -= 1;
      g_res_addrs.erase(ae);
    }
  }
}

// Seeded deterministic decimation (the mu-prof/natfault discipline:
// replayable for a given seed, not modulo-phased across threads).
bool res_sample_this() {
  uint32_t every = g_res_every.load(std::memory_order_relaxed);
  if (every <= 1) return true;
  static thread_local uint64_t n = 0;
  return nat_mix64(g_res_seed.load(std::memory_order_relaxed) ^ ++n) %
             every ==
         0;
}

std::string res_symbolize(uintptr_t pc,
                          std::map<uintptr_t, std::string>* cache) {
  if ((pc & ~(uintptr_t)0xffff) == kResSubTag) {
    int sub = (int)(pc & 0xffff);
    char buf[40];
    snprintf(buf, sizeof(buf), "res:%s",
             sub >= 0 && sub < NR_SUBSYS_COUNT ? kResNames[sub] : "?");
    return buf;
  }
  return nat_prof_symbolize_pc(pc, cache);
}

// Render a live-bytes-by-site map as text. mode 0 = flat by leaf
// symbol, mode 1 = collapsed stacks (root..leaf value). `value_of`
// selects the weight so the heap and growth reports share one body.
template <typename Map, typename ValueFn>
std::string res_render(const Map& sites, ValueFn value_of, int mode,
                       const char* header) {
  std::map<uintptr_t, std::string> symcache;
  std::string text = header;
  if (mode == 0) {
    std::map<std::string, uint64_t> flat;
    for (const auto& kv : sites) {
      uint64_t v = value_of(kv.second);
      if (v == 0) continue;
      flat[res_symbolize(kv.first.front(), &symcache)] += v;
    }
    std::vector<std::pair<uint64_t, const std::string*>> rows;
    rows.reserve(flat.size());
    for (const auto& kv : flat) rows.emplace_back(kv.second, &kv.first);
    std::sort(rows.begin(), rows.end(),
              [](const auto& a, const auto& b) { return a.first > b.first; });
    for (const auto& r : rows) {
      char line[256];
      snprintf(line, sizeof(line), "%12llu  %s\n",
               (unsigned long long)r.first, r.second->c_str());
      text += line;
    }
  } else {
    std::map<std::string, uint64_t> folded;
    std::string key;
    for (const auto& kv : sites) {
      uint64_t v = value_of(kv.second);
      if (v == 0) continue;
      key.clear();
      for (size_t i = kv.first.size(); i-- > 0;) {
        if (!key.empty()) key += ';';
        key += res_symbolize(kv.first[i], &symcache);
      }
      folded[key] += v;
    }
    for (const auto& kv : folded) {
      text += kv.first;
      char cnt[32];
      snprintf(cnt, sizeof(cnt), " %llu\n", (unsigned long long)kv.second);
      text += cnt;
    }
  }
  return text;
}

int res_text_out(const std::string& text, char** out, size_t* out_len) {
  // natcheck:allow(resacct): FFI report buffer, freed by the caller
  char* buf = (char*)malloc(text.size() + 1);
  if (buf == nullptr) return -1;
  memcpy(buf, text.data(), text.size());
  buf[text.size()] = '\0';
  *out = buf;
  *out_len = text.size();
  return 0;
}

// the observatory's own fixed pools, attributed like nat_prof's —
// BOTH under the fixed-BSS subsystem: the /status RSS reconciliation
// excludes prof.cells from the heap-accounted share because untouched
// BSS pages are virtual (stats.cell stays the HEAP-allocated NatStatCell
// subsystem)
const bool g_res_pools_registered = [] {
  NAT_RES_STATIC(NR_PROF_CELLS, sizeof(g_res_rings) + sizeof(g_res_cells) +
                                    sizeof(g_res_overflow));
  return true;
}();

}  // namespace

// ---------------------------------------------------------------------------
// record API (nat_res.h macros land here)
// ---------------------------------------------------------------------------

void nat_res_alloc(int sub, size_t bytes, void* ptr) {
  if (sub < 0 || sub >= NR_SUBSYS_COUNT) return;
  NatResCell* c = res_cell();
  c->alloc_bytes[sub].fetch_add(bytes, std::memory_order_relaxed);
  c->allocs[sub].fetch_add(1, std::memory_order_relaxed);
  int64_t live = g_res_live_bytes[sub].fetch_add(
                     (int64_t)bytes, std::memory_order_relaxed) +
                 (int64_t)bytes;
  res_hwm_update(sub, live);
  if (g_res_on.load(std::memory_order_relaxed) && res_sample_this()) {
    uintptr_t pcs[kResMaxFrames];
    int depth = nat_fp_backtrace(pcs, kResMaxFrames);
    res_ring_publish(0, sub, bytes, ptr, pcs, depth);
  }
}

void nat_res_free(int sub, size_t bytes, void* ptr) {
  if (sub < 0 || sub >= NR_SUBSYS_COUNT) return;
  NatResCell* c = res_cell();
  c->free_bytes[sub].fetch_add(bytes, std::memory_order_relaxed);
  c->frees[sub].fetch_add(1, std::memory_order_relaxed);
  g_res_live_bytes[sub].fetch_sub((int64_t)bytes,
                                  std::memory_order_relaxed);
  if (g_res_on.load(std::memory_order_relaxed)) {
    // frees are never decimated (no stack to pay for): a sampled
    // alloc's free must reach the address map or its site leaks
    res_ring_publish(1, sub, bytes, ptr, nullptr, 0);
  }
}

void nat_res_static(int sub, size_t bytes) {
  // a live allocation that never frees; keyed by a synthetic address so
  // repeated registration of distinct pools never collides
  static std::atomic<uintptr_t> key{0x5747u};
  nat_res_alloc(sub, bytes,
                (void*)key.fetch_add(1, std::memory_order_relaxed));
}

}  // namespace brpc_tpu

using namespace brpc_tpu;

extern "C" {

int nat_res_count(void) { return NR_SUBSYS_COUNT; }

const char* nat_res_name(int sub) {
  if (sub < 0 || sub >= NR_SUBSYS_COUNT) return "";
  return kResNames[sub];
}

// Snapshot every subsystem row (combined cells + global hwm). Returns
// rows written. Opportunistically folds the profiler rings while armed
// (try_lock: a scrape must never block behind a running report).
int nat_res_stats(brpc_tpu::NatResRow* out, int max) {
  if (g_res_on.load(std::memory_order_acquire) &&
      g_res_report_mu.try_lock()) {
    res_drain_locked();
    g_res_report_mu.unlock();
  }
  int n = max < NR_SUBSYS_COUNT ? max : (int)NR_SUBSYS_COUNT;
  for (int sub = 0; sub < n; sub++) {
    uint64_t ab = g_res_overflow.alloc_bytes[sub].load(
        std::memory_order_relaxed);
    uint64_t fb =
        g_res_overflow.free_bytes[sub].load(std::memory_order_relaxed);
    uint64_t na =
        g_res_overflow.allocs[sub].load(std::memory_order_relaxed);
    uint64_t nf =
        g_res_overflow.frees[sub].load(std::memory_order_relaxed);
    for (const auto& c : g_res_cells) {
      if (c.tid.load(std::memory_order_acquire) == 0) continue;
      ab += c.alloc_bytes[sub].load(std::memory_order_relaxed);
      fb += c.free_bytes[sub].load(std::memory_order_relaxed);
      na += c.allocs[sub].load(std::memory_order_relaxed);
      nf += c.frees[sub].load(std::memory_order_relaxed);
    }
    NatResRow& r = out[sub];
    r.live_bytes = ab > fb ? ab - fb : 0;
    r.live_objects = na > nf ? na - nf : 0;
    r.cum_allocs = na;
    r.cum_frees = nf;
    r.cum_alloc_bytes = ab;
    int64_t hwm = g_res_hwm_bytes[sub].load(std::memory_order_relaxed);
    r.hwm_bytes = hwm > 0 ? (uint64_t)hwm : 0;
    snprintf(r.name, sizeof(r.name), "%s", kResNames[sub]);
  }
  return n;
}

// Total live bytes across every subsystem — the /status RSS
// reconciliation's accounted side.
uint64_t nat_res_accounted_bytes(void) {
  int64_t total = 0;
  for (int sub = 0; sub < NR_SUBSYS_COUNT; sub++) {
    int64_t v = g_res_live_bytes[sub].load(std::memory_order_relaxed);
    if (v > 0) total += v;
  }
  return (uint64_t)total;
}

// Arm allocation-site sampling: 1-in-`every` allocations (<= 1 = all;
// seeded deterministic decimation) capture a frame-pointer stack.
// Takes the growth baseline if none exists yet. Returns 0, -1 when
// already running.
int nat_res_prof_start(int every, uint64_t seed) {
  std::lock_guard g(g_res_report_mu);
  if (g_res_on.load(std::memory_order_acquire)) return -1;
  g_res_every.store(every > 1 ? (uint32_t)every : 1,
                    std::memory_order_relaxed);
  g_res_seed.store(seed, std::memory_order_relaxed);
  if (!g_res_baseline_taken) {
    g_res_baseline.clear();
    for (const auto& kv : g_res_sites) {
      if (kv.second.live_bytes > 0) {
        g_res_baseline[kv.first] = kv.second.live_bytes;
      }
    }
    g_res_baseline_taken = true;
  }
  g_res_on.store(true, std::memory_order_release);
  return 0;
}

// Stop sampling and fold the rings (sites stay reportable). Safe when
// not running.
int nat_res_prof_stop(void) {
  std::lock_guard g(g_res_report_mu);
  g_res_on.store(false, std::memory_order_release);
  res_drain_locked();
  return 0;
}

int nat_res_prof_running(void) {
  return g_res_on.load(std::memory_order_acquire) ? 1 : 0;
}

uint64_t nat_res_prof_samples(void) {
  return g_res_samples.load(std::memory_order_relaxed);
}

// Forget every sampled site, address entry, baseline and undrained
// ring event (test hygiene; the always-on ledger is untouched).
void nat_res_prof_reset(void) {
  std::lock_guard g(g_res_report_mu);
  for (auto& c : g_res_rings) {
    c.next_read = c.head.load(std::memory_order_acquire);
  }
  g_res_sites.clear();
  g_res_addrs.clear();
  g_res_baseline.clear();
  g_res_baseline_taken = false;
  g_res_samples.store(0, std::memory_order_relaxed);
  g_res_dropped.store(0, std::memory_order_relaxed);
}

// /heap/native: live bytes by allocation site. mode 0 = flat by leaf
// symbol, mode 1 = collapsed stacks weighted by live bytes
// (flamegraph/speedscope). *out malloc'd (free with nat_buf_free);
// 0 ok, -1 OOM.
int nat_res_heap_report(int mode, char** out, size_t* out_len) {
  if (out == nullptr || out_len == nullptr) return -1;
  std::string text;
  {
    std::lock_guard g(g_res_report_mu);
    res_drain_locked();
    uint64_t total = 0, nsites = 0;
    for (const auto& kv : g_res_sites) {
      if (kv.second.live_bytes == 0) continue;
      total += kv.second.live_bytes;
      nsites++;
    }
    char hdr[224];
    snprintf(hdr, sizeof(hdr),
             "# nat_res heap: %llu sites, %llu bytes live (sampled "
             "1-in-%u since arming; %llu events, %llu dropped), %s\n",
             (unsigned long long)nsites, (unsigned long long)total,
             g_res_every.load(std::memory_order_relaxed),
             (unsigned long long)g_res_samples.load(
                 std::memory_order_relaxed),
             (unsigned long long)g_res_dropped.load(
                 std::memory_order_relaxed),
             mode == 0 ? "flat live bytes by leaf"
                       : "collapsed stacks, value = live bytes");
    text = res_render(g_res_sites,
                      [](const SiteAgg& a) { return a.live_bytes; },
                      mode, hdr);
  }
  return res_text_out(text, out, out_len);
}

// Re-take the /growth/native baseline: current live-bytes-by-site
// becomes the zero point the next growth report diffs against.
int nat_res_growth_baseline(void) {
  std::lock_guard g(g_res_report_mu);
  res_drain_locked();
  g_res_baseline.clear();
  for (const auto& kv : g_res_sites) {
    if (kv.second.live_bytes > 0) {
      g_res_baseline[kv.first] = kv.second.live_bytes;
    }
  }
  g_res_baseline_taken = true;
  return 0;
}

// /growth/native: live-bytes-by-site GROWTH since the baseline —
// collapsed stacks whose value is (current live - baseline live) where
// positive. *out malloc'd (free with nat_buf_free); 0 ok, -1 OOM.
int nat_res_growth_report(char** out, size_t* out_len) {
  if (out == nullptr || out_len == nullptr) return -1;
  std::string text;
  {
    std::lock_guard g(g_res_report_mu);
    res_drain_locked();
    std::map<std::vector<uintptr_t>, SiteAgg> grown;
    uint64_t total = 0;
    for (const auto& kv : g_res_sites) {
      auto bit = g_res_baseline.find(kv.first);
      uint64_t base = bit != g_res_baseline.end() ? bit->second : 0;
      if (kv.second.live_bytes > base) {
        SiteAgg a;
        a.live_bytes = kv.second.live_bytes - base;
        grown.emplace(kv.first, a);
        total += a.live_bytes;
      }
    }
    char hdr[192];
    snprintf(hdr, sizeof(hdr),
             "# nat_res growth: %llu growing sites, %llu bytes grown "
             "since baseline (%llu dropped)\n"
             "# format: collapsed stacks, value = grown live bytes\n",
             (unsigned long long)grown.size(), (unsigned long long)total,
             (unsigned long long)g_res_dropped.load(
                 std::memory_order_relaxed));
    text = res_render(grown,
                      [](const SiteAgg& a) { return a.live_bytes; }, 1,
                      hdr);
  }
  return res_text_out(text, out, out_len);
}

// Deterministic churn for tests/smokes: `nthreads` threads each run
// `iters` alloc/free rounds on the selftest subsystem (mixed sizes,
// cross-checked ledger balance) while a reader thread snapshots rows
// and — when this call armed the profiler — the rings drain
// concurrently. Returns 0 when the ledger balances exactly, -1
// otherwise. Exercises the exact production record paths.
int nat_res_selftest(int nthreads, int iters) {
  if (nthreads < 2) nthreads = 2;
  if (nthreads > 16) nthreads = 16;
  if (iters <= 0) iters = 200;
  NatResRow before[NR_SUBSYS_COUNT];
  nat_res_stats(before, NR_SUBSYS_COUNT);
  bool armed = nat_res_prof_start(1, 42) == 0;
  std::atomic<bool> stop{false};
  std::thread reader([&] {
    NatResRow rows[NR_SUBSYS_COUNT];
    char* rep = nullptr;
    size_t rep_len = 0;
    while (!stop.load(std::memory_order_acquire)) {
      (void)nat_res_stats(rows, NR_SUBSYS_COUNT);
      if (nat_res_heap_report(1, &rep, &rep_len) == 0) {
        nat_buf_free(rep);
        rep = nullptr;
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });
  std::vector<std::thread> churners;
  churners.reserve((size_t)nthreads);
  for (int t = 0; t < nthreads; t++) {
    churners.emplace_back([t, iters] {
      for (int i = 0; i < iters; i++) {
        size_t sz = 64 + (size_t)((i * 37 + t * 101) % 4096);
        void* key = (void*)(((uintptr_t)(t + 1) << 40) | (uintptr_t)i);
        NAT_RES_ALLOC(NR_SELFTEST, sz, key);
        if (i % 8 == 0) std::this_thread::yield();
        NAT_RES_FREE(NR_SELFTEST, sz, key);
      }
    });
  }
  for (auto& th : churners) th.join();
  stop.store(true, std::memory_order_release);
  reader.join();
  if (armed) nat_res_prof_stop();
  NatResRow after[NR_SUBSYS_COUNT];
  nat_res_stats(after, NR_SUBSYS_COUNT);
  const NatResRow& b = before[NR_SELFTEST];
  const NatResRow& a = after[NR_SELFTEST];
  uint64_t did = (uint64_t)nthreads * (uint64_t)iters;
  if (a.live_bytes != b.live_bytes || a.live_objects != b.live_objects ||
      a.cum_allocs != b.cum_allocs + did ||
      a.cum_frees != b.cum_frees + did) {
    fprintf(stderr,
            "nat_res_selftest: UNBALANCED selftest ledger: live_bytes "
            "%llu->%llu live_objs %llu->%llu allocs %llu->%llu frees "
            "%llu->%llu (expected +%llu each)\n",
            (unsigned long long)b.live_bytes,
            (unsigned long long)a.live_bytes,
            (unsigned long long)b.live_objects,
            (unsigned long long)a.live_objects,
            (unsigned long long)b.cum_allocs,
            (unsigned long long)a.cum_allocs,
            (unsigned long long)b.cum_frees,
            (unsigned long long)a.cum_frees, (unsigned long long)did);
    return -1;
  }
  return 0;
}

}  // extern "C"
