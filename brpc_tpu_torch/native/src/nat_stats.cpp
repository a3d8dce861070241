// nat_stats — cell registry, combiner, span ring, and the extern "C"
// snapshot surface consumed by brpc_tpu/native via ctypes (the /vars,
// /brpc_metrics and /rpcz data source for native traffic). See nat_stats.h
// for the design map to bvar.
#include "nat_api.h"
#include "nat_stats.h"

#include <stdio.h>
#include <string.h>
#include <stdlib.h>

#include <mutex>
#include "nat_lockrank.h"
#include "nat_res.h"

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// cell registry — cells are never freed (an exited thread's monotonic
// counts must keep contributing to the combined totals, exactly like
// bvar's global combiner keeps exited agents' sums)
// ---------------------------------------------------------------------------

static constexpr int kMaxCells = 512;
static std::atomic<NatStatCell*> g_cells[kMaxCells];
static std::atomic<int> g_ncells{0};
static NatMutex<kLockRankStatsCell> g_cell_mu;
// overflow cell: thread #513+ shares one cell; the relaxed load+store
// write discipline makes sharing lossy under contention, but 512
// registered threads means the process has bigger problems
static NatStatCell g_overflow_cell;

thread_local NatStatCell* tls_nat_cell = nullptr;

// natcheck:leak(nat_cell_slow): per-thread stat cells are never freed —
// an exited thread's monotonic counters must keep contributing to
// combined totals (bvar discipline).
NatStatCell* nat_cell_slow() {
  std::lock_guard g(g_cell_mu);
  int n = g_ncells.load(std::memory_order_relaxed);
  NatStatCell* c;
  if (n < kMaxCells) {
    c = new NatStatCell();  // zero-initialized (atomics value-init to 0)
    NAT_RES_ALLOC(NR_STATS_CELL, sizeof(NatStatCell), c);
    g_cells[n].store(c, std::memory_order_release);
    g_ncells.store(n + 1, std::memory_order_release);
  } else {
    c = &g_overflow_cell;
  }
  tls_nat_cell = c;
  return c;
}

// gauges (PassiveStatus role): value computed at snapshot time
static uint64_t (*g_gauges[NS_COUNTER_COUNT])() = {};

void nat_stats_register_gauge(int counter_id, uint64_t (*fn)()) {
  if (counter_id >= 0 && counter_id < NS_COUNTER_COUNT) {
    g_gauges[counter_id] = fn;
  }
}

static uint64_t combined_counter(int id) {
  if (g_gauges[id] != nullptr) return g_gauges[id]();
  uint64_t sum = g_overflow_cell.counters[id].load(std::memory_order_relaxed);
  int n = g_ncells.load(std::memory_order_acquire);
  for (int i = 0; i < n; i++) {
    NatStatCell* c = g_cells[i].load(std::memory_order_acquire);
    if (c != nullptr) sum += c->counters[id].load(std::memory_order_relaxed);
  }
  return sum;
}

static const char* kCounterNames[NS_COUNTER_COUNT] = {
    "nat_socket_read_bytes",
    "nat_socket_write_bytes",
    "nat_connections_accepted",
    "nat_tpu_std_msgs_in",
    "nat_tpu_std_responses_out",
    "nat_tpu_std_errors",
    "nat_http_msgs_in",
    "nat_http_responses_out",
    "nat_http_errors",
    "nat_grpc_msgs_in",
    "nat_grpc_responses_out",
    "nat_grpc_errors",
    "nat_redis_msgs_in",
    "nat_redis_responses_out",
    "nat_redis_errors",
    "nat_client_calls",
    "nat_client_responses",
    "nat_client_errors",
    "nat_py_dispatches",
    "nat_py_queue_depth",
    "nat_spans_dropped",
    "nat_faults_injected",
    "nat_elimit_rejects",
    "nat_queue_deadline_drops",
    "nat_retry_budget_exhausted",
    "nat_breaker_isolations",
    "nat_breaker_revivals",
    "nat_dispatcher_wakeups",
    "nat_wsq_steals",
    "nat_worker_parks",
    "nat_sqpoll_rings",
    "nat_quiesce_lame_duck_sent",
    "nat_quiesce_drained_ok",
    "nat_quiesce_drain_deadline_drops",
    "nat_quiesce_draining_redials",
    "nat_dump_samples",
    "nat_dump_records_written",
    "nat_dump_bytes_written",
    "nat_dump_drops",
    "nat_dump_oversize",
    "nat_dump_rotations",
    "nat_replay_calls",
    "nat_replay_errors",
    "nat_lb_selects",
    "nat_fanout_calls",
    "nat_fanout_subcalls",
    "nat_fanout_subcall_errors",
    "nat_fanout_fails",
    "nat_cluster_updates",
    "nat_cluster_backends_added",
    "nat_cluster_backends_removed",
    "nat_fabric_pushes",
    "nat_fabric_takes",
    "nat_fabric_recover_drops",
    "nat_bulk_fill_frames",
    "nat_stats_snapshots",
    "nat_dynpart_resizes",
    "nat_autoscale_grows",
    "nat_autoscale_shrinks",
    "nat_autoscale_blocked",
};

static const char* kLaneNames[NL_LANE_COUNT] = {
    "echo", "http", "redis", "grpc", "client", "worker",
};

thread_local NatTraceCtx tls_nat_trace;

// ---------------------------------------------------------------------------
// per-method stats — fixed open-addressed (lane, method) table. Slots are
// claimed once and never freed (a handed-out index must stay valid while
// a shm in-flight entry holds it across seconds); lookups are lock-free
// (state acquire gates the key bytes), inserts race via the state CAS.
// ---------------------------------------------------------------------------

namespace {

struct NatMethodCell {
  // 0 = free, 1 = claiming (key being written), 2 = ready
  std::atomic<uint32_t> state{0};
  int32_t lane = 0;
  char method[kNatMethodNameLen] = {0};
  std::atomic<uint64_t> count{0};
  std::atomic<uint64_t> errors{0};
  std::atomic<int64_t> concurrency{0};
  std::atomic<int64_t> max_concurrency{0};
  std::atomic<uint64_t> hist[kNatHistBuckets];
};

NatMethodCell g_methods[kNatMethodSlots];

uint64_t method_hash(int lane, const char* method, size_t len) {
  uint64_t h = 1469598103934665603ull ^ (uint64_t)lane;
  for (size_t i = 0; i < len; i++) {
    h = (h ^ (uint8_t)method[i]) * 1099511628211ull;
  }
  return nat_mix64(h);
}

// Per-lane "(other)" rows absorb calls once the table is full — method
// names arrive off the wire (HTTP paths, redis command words), so a
// client spraying unique names must degrade attribution, not disable
// it. Claimed at .so load while the table is guaranteed empty.
int g_method_overflow[NL_LANE_COUNT];
const bool g_method_overflow_init = [] {
  for (int lane = 0; lane < NL_LANE_COUNT; lane++) {
    g_method_overflow[lane] = nat_method_idx(lane, "(other)", 7);
  }
  return true;
}();

}  // namespace

int nat_method_idx(int lane, const char* method, size_t len) {
  if (len >= kNatMethodNameLen) len = kNatMethodNameLen - 1;
  uint32_t start = (uint32_t)(method_hash(lane, method, len) %
                              kNatMethodSlots);
  for (int probe = 0; probe < kNatMethodSlots; probe++) {
    int idx = (int)((start + (uint32_t)probe) % kNatMethodSlots);
    NatMethodCell& c = g_methods[idx];
    uint32_t st = c.state.load(std::memory_order_acquire);
    if (st == 2) {
      if (c.lane == lane && strncmp(c.method, method, len) == 0 &&
          c.method[len] == '\0') {
        return idx;
      }
      continue;
    }
    if (st == 0) {
      uint32_t expect = 0;
      if (c.state.compare_exchange_strong(expect, 1,
                                          std::memory_order_acq_rel)) {
        c.lane = lane;
        memcpy(c.method, method, len);
        c.method[len] = '\0';
        c.state.store(2, std::memory_order_release);
        return idx;
      }
    }
    // claiming (st == 1) or lost the claim race: the claimer may be
    // writing OUR key — spin this slot briefly waiting for it to publish
    for (int spin = 0; spin < 64; spin++) {
      if (c.state.load(std::memory_order_acquire) == 2) break;
    }
    if (c.state.load(std::memory_order_acquire) == 2) {
      if (c.lane == lane && strncmp(c.method, method, len) == 0 &&
          c.method[len] == '\0') {
        return idx;
      }
      continue;  // published someone else's key — keep probing
    }
    // still mid-claim after the spin budget (claimer descheduled): it
    // may be seating OUR key, and probing on could claim a SECOND slot
    // for the same (lane, method) — a permanent stats split. Degrade
    // this one call to "(other)" instead; the next call re-probes.
    break;
  }
  // table full: aggregate into the lane's "(other)" row (claimed at
  // load time, so it exists even when wire traffic filled every slot)
  return lane >= 0 && lane < NL_LANE_COUNT ? g_method_overflow[lane] : -1;
}

// Lookup-only probe: never claims a slot. Read-side APIs (quantile
// queries over caller-supplied names) must not burn table slots on
// typos or methods that never ran.
int nat_method_find(int lane, const char* method, size_t len) {
  if (len >= kNatMethodNameLen) len = kNatMethodNameLen - 1;
  uint32_t start = (uint32_t)(method_hash(lane, method, len) %
                              kNatMethodSlots);
  for (int probe = 0; probe < kNatMethodSlots; probe++) {
    int idx = (int)((start + (uint32_t)probe) % kNatMethodSlots);
    NatMethodCell& c = g_methods[idx];
    uint32_t st = c.state.load(std::memory_order_acquire);
    if (st == 0) return -1;  // first free slot in probe order: absent
    if (st == 2 && c.lane == lane && strncmp(c.method, method, len) == 0 &&
        c.method[len] == '\0') {
      return idx;
    }
  }
  return -1;
}

void nat_method_begin(int idx) {
  if (idx < 0 || idx >= kNatMethodSlots) return;
  NatMethodCell& c = g_methods[idx];
  int64_t now = c.concurrency.fetch_add(1, std::memory_order_relaxed) + 1;
  int64_t max = c.max_concurrency.load(std::memory_order_relaxed);
  while (now > max && !c.max_concurrency.compare_exchange_weak(
                          max, now, std::memory_order_relaxed)) {
  }
}

void nat_method_end(int idx, uint64_t latency_ns, bool error) {
  if (idx < 0 || idx >= kNatMethodSlots) return;
  NatMethodCell& c = g_methods[idx];
  c.concurrency.fetch_sub(1, std::memory_order_relaxed);
  c.count.fetch_add(1, std::memory_order_relaxed);
  if (error) c.errors.fetch_add(1, std::memory_order_relaxed);
  c.hist[nat_hist_bucket(latency_ns)].fetch_add(1,
                                                std::memory_order_relaxed);
}

void nat_method_abort(int idx) {
  if (idx < 0 || idx >= kNatMethodSlots) return;
  g_methods[idx].concurrency.fetch_sub(1, std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// span ring — seqlock slots under a monotonically-increasing ticket: the
// writer marks a slot busy (odd), fills it, then publishes (2*ticket+2);
// the drainer skips torn or overwritten slots instead of locking writers
// ---------------------------------------------------------------------------

std::atomic<uint32_t> g_nat_span_every{0};

struct SpanSlot {
  std::atomic<uint64_t> seq{0};
  NatSpanRec rec;
};
static SpanSlot g_span_ring[kNatSpanRing];
// fixed BSS span ring, attributed for the RSS reconciliation
static const bool g_span_ring_registered = [] {
  NAT_RES_STATIC(NR_PROF_CELLS, sizeof(g_span_ring));
  return true;
}();
static std::atomic<uint64_t> g_span_head{0};  // next ticket
static NatMutex<kLockRankStatsSpan> g_span_drain_mu;
static uint64_t g_span_next_read = 0;  // under g_span_drain_mu

bool nat_span_tick() {
  uint32_t every = g_nat_span_every.load(std::memory_order_relaxed);
  if (every == 0) return false;
  static thread_local uint32_t n = 0;
  return ++n % every == 0;
}

// xorshift ids, seeded per thread (random.getrandbits role; spans need
// unique-enough ids, not cryptographic ones)
static uint64_t span_rand() {
  static thread_local uint64_t state = 0;
  if (state == 0) {
    state = nat_now_ns() ^ ((uint64_t)(uintptr_t)&state << 17) ^ 0x9e3779b97f4a7c15ull;
  }
  state ^= state << 13;
  state ^= state >> 7;
  state ^= state << 17;
  return state;
}

// TSan cannot model the seqlock: the plain rec copy intentionally races
// the drainer's read, which detects the overlap via the seq recheck and
// discards the torn snapshot. Without the annotation the smoke reports
// this benign race intermittently.
__attribute__((no_sanitize("thread")))
void nat_span_submit(const NatSpanRec& rec) {
  uint64_t ticket = g_span_head.fetch_add(1, std::memory_order_relaxed);
  SpanSlot& slot = g_span_ring[ticket & (kNatSpanRing - 1)];
  slot.seq.store(2 * ticket + 1, std::memory_order_relaxed);  // busy
  // full fence: the rec bytes must not become visible BEFORE the busy
  // mark (a release store only keeps PRIOR writes above it; later plain
  // stores could otherwise float up past it on weakly-ordered CPUs)
  std::atomic_thread_fence(std::memory_order_seq_cst);
  slot.rec = rec;
  slot.seq.store(2 * ticket + 2, std::memory_order_release);  // published
}

uint64_t nat_span_id63() { return span_rand() & 0x7fffffffffffffffull; }

void nat_span_record(int lane, uint64_t sock_id, const char* method,
                     size_t method_len, uint64_t recv_ns, uint64_t parse_ns,
                     uint64_t dispatch_ns, uint64_t write_ns,
                     int32_t error_code, uint32_t req_bytes,
                     uint32_t resp_bytes, uint64_t trace_id,
                     uint64_t parent_span_id) {
  NatSpanRec rec;
  rec.trace_id = trace_id != 0 ? trace_id : nat_span_id63();
  rec.span_id = nat_span_id63();
  rec.parent_span_id = parent_span_id;
  rec.sock_id = sock_id;
  rec.recv_ns = recv_ns;
  rec.parse_ns = parse_ns;
  rec.dispatch_ns = dispatch_ns;
  rec.write_ns = write_ns;
  rec.protocol = lane;
  rec.error_code = error_code;
  rec.req_bytes = req_bytes;
  rec.resp_bytes = resp_bytes;
  size_t n = method_len < sizeof(rec.method) - 1 ? method_len
                                                 : sizeof(rec.method) - 1;
  memcpy(rec.method, method, n);
  rec.method[n] = '\0';
  nat_span_submit(rec);
}

// Quantile (0..1) over a log2 histogram, interpolated within the
// winning bucket. ns; 0.0 when empty. Shared by the lane/per-method
// quantile exports AND nat_replay.cpp's run-local histogram, so the
// interpolation can never diverge between them (declared nat_stats.h).
double nat_hist_quantile(const uint64_t* buckets, int nb, double q) {
  uint64_t total = 0;
  for (int b = 0; b < nb; b++) total += buckets[b];
  if (total == 0) return 0.0;
  if (q < 0.0) q = 0.0;
  if (q > 1.0) q = 1.0;
  double target = q * (double)total;
  double acc = 0.0;
  for (int b = 0; b < nb; b++) {
    if (buckets[b] == 0) continue;
    if (acc + (double)buckets[b] >= target) {
      double lo = b == 0 ? 0.0 : (double)(1ull << (b - 1));
      double hi = (double)(1ull << b);
      double frac = (target - acc) / (double)buckets[b];
      return lo + frac * (hi - lo);
    }
    acc += (double)buckets[b];
  }
  return (double)(1ull << (nb - 1));
}

}  // namespace brpc_tpu

// ---------------------------------------------------------------------------
// C API (ctypes surface) — see also api.cpp for the scheduler/selftest
// surface; the stats snapshot lives here beside the data it reads.
// ---------------------------------------------------------------------------

using namespace brpc_tpu;

extern "C" {

int nat_stats_counter_count() { return NS_COUNTER_COUNT; }

// The span clock (CLOCK_MONOTONIC ns): lets the drainer map NatSpanRec
// timestamps onto wall time with one offset computed at drain time.
uint64_t nat_stats_now_ns() { return nat_now_ns(); }

const char* nat_stats_counter_name(int id) {
  if (id < 0 || id >= NS_COUNTER_COUNT) return "";
  return kCounterNames[id];
}

// By-name counter bump for embedder-side events that belong in the ONE
// native counter surface (the autoscaler's grow/shrink/blocked actions:
// a Python controller, but its counters must ride /vars, /brpc_metrics
// and the fleet scrape like every native counter). Returns the counter
// id, or -1 for an unknown name.
int nat_stats_counter_bump(const char* name, uint64_t delta) {
  if (name == nullptr) return -1;
  for (int i = 0; i < NS_COUNTER_COUNT; i++) {
    if (strcmp(kCounterNames[i], name) == 0) {
      nat_counter_add(i, delta);
      return i;
    }
  }
  return -1;
}

// Combined snapshot of every counter (gauges computed in place). Returns
// the number of values written.
int nat_stats_counters(uint64_t* out, int max) {
  int n = max < NS_COUNTER_COUNT ? max : (int)NS_COUNTER_COUNT;
  for (int i = 0; i < n; i++) out[i] = combined_counter(i);
  return n;
}

int nat_stats_lane_count() { return NL_LANE_COUNT; }

const char* nat_stats_lane_name(int lane) {
  if (lane < 0 || lane >= NL_LANE_COUNT) return "";
  return kLaneNames[lane];
}

int nat_stats_hist_nbuckets() { return kNatHistBuckets; }

// Combined log2 histogram of one lane. Returns buckets written.
int nat_stats_hist(int lane, uint64_t* out, int max) {
  if (lane < 0 || lane >= NL_LANE_COUNT) return 0;
  int nb = max < kNatHistBuckets ? max : (int)kNatHistBuckets;
  for (int b = 0; b < nb; b++) {
    out[b] = g_overflow_cell.hist[lane][b].load(std::memory_order_relaxed);
  }
  int n = g_ncells.load(std::memory_order_acquire);
  for (int i = 0; i < n; i++) {
    NatStatCell* c = g_cells[i].load(std::memory_order_acquire);
    if (c == nullptr) continue;
    for (int b = 0; b < nb; b++) {
      out[b] += c->hist[lane][b].load(std::memory_order_relaxed);
    }
  }
  return nb;
}

double nat_stats_hist_quantile(int lane, double q) {
  uint64_t buckets[kNatHistBuckets];
  int nb = nat_stats_hist(lane, buckets, kNatHistBuckets);
  if (nb == 0) return 0.0;
  return brpc_tpu::nat_hist_quantile(buckets, nb, q);
}

// Snapshot the per-method table: fills up to `max` rows (used slots in
// pool order) and returns the number written.
int nat_method_stats(NatMethodStatRow* out, int max) {
  int n = 0;
  for (int i = 0; i < kNatMethodSlots && n < max; i++) {
    NatMethodCell& c = g_methods[i];
    if (c.state.load(std::memory_order_acquire) != 2) continue;
    NatMethodStatRow& r = out[n++];
    r.count = c.count.load(std::memory_order_relaxed);
    r.errors = c.errors.load(std::memory_order_relaxed);
    r.concurrency = c.concurrency.load(std::memory_order_relaxed);
    r.max_concurrency = c.max_concurrency.load(std::memory_order_relaxed);
    r.lane = c.lane;
    memcpy(r.method, c.method, kNatMethodNameLen);
  }
  return n;
}

// Latency quantile (ns) over one method's log2 histogram; 0.0 when the
// method is unknown or empty.
double nat_method_quantile(int lane, const char* method, double q) {
  if (method == nullptr) return 0.0;
  int idx = nat_method_find(lane, method, strlen(method));
  if (idx < 0) return 0.0;
  NatMethodCell& c = g_methods[idx];
  uint64_t buckets[kNatHistBuckets];
  for (int b = 0; b < kNatHistBuckets; b++) {
    buckets[b] = c.hist[b].load(std::memory_order_relaxed);
  }
  return brpc_tpu::nat_hist_quantile(buckets, kNatHistBuckets, q);
}

// Raw log2 buckets of one method's latency histogram (lookup-only; -1
// when the method has no slot). The FLEET seam: log2 histograms merge
// exactly by bucket-wise addition, so a collector that wants a
// cross-process quantile must take the buckets off each member and merge
// — never average per-member percentiles.
int nat_method_hist(int lane, const char* method, uint64_t* out, int max) {
  if (method == nullptr || out == nullptr || max <= 0) return -1;
  int idx = nat_method_find(lane, method, strlen(method));
  if (idx < 0) return -1;
  NatMethodCell& c = g_methods[idx];
  int nb = max < kNatHistBuckets ? max : (int)kNatHistBuckets;
  for (int b = 0; b < nb; b++) {
    out[b] = c.hist[b].load(std::memory_order_relaxed);
  }
  return nb;
}

}  // extern "C"

namespace {

// Sparse bucket rendering: [[bucket, count], ...] — at 1Hz scrape the
// snapshot rides the wire every second, so empty buckets (most of the
// 44, most of the time) must not pay bytes.
void append_buckets_json(std::string* s, const uint64_t* b, int nb) {
  s->append("[");
  bool first = true;
  for (int i = 0; i < nb; i++) {
    if (b[i] == 0) continue;
    char tmp[48];
    snprintf(tmp, sizeof(tmp), "%s[%d,%llu]", first ? "" : ",", i,
             (unsigned long long)b[i]);
    s->append(tmp);
    first = false;
  }
  s->append("]");
}

// Method names arrive off the wire (HTTP paths, redis command words):
// escape the JSON-breaking bytes before they enter the snapshot.
void append_escaped_json(std::string* s, const char* p) {
  for (; *p != '\0'; p++) {
    unsigned char c = (unsigned char)*p;
    if (c == '"' || c == '\\') {
      s->push_back('\\');
      s->push_back((char)c);
    } else if (c < 0x20) {
      char tmp[8];
      snprintf(tmp, sizeof(tmp), "\\u%04x", c);
      s->append(tmp);
    } else {
      s->push_back((char)c);
    }
  }
}

}  // namespace

extern "C" {

// The versioned compact snapshot behind the builtin.stats tpu_std
// endpoint: counters (gauges computed in place), per-lane and per-method
// log2 histograms WITH raw buckets (the mergeable form — fleet quantiles
// come from merged buckets, never averaged percentiles), server
// overload/quiesce state, open client channels (breaker/lame-duck), and
// the nat_res subsystem ledger. One malloc, caller frees via
// nat_buf_free. Cheap by construction: one pass over the stat cells and
// the 128-slot method table, no locks beyond the channel-registry leaf.
int nat_stats_snapshot(char** out, size_t* out_len) {
  if (out == nullptr || out_len == nullptr) return -1;
  nat_counter_add(NS_STATS_SNAPSHOTS, 1);
  std::string s;
  s.reserve(8192);
  char tmp[192];
  snprintf(tmp, sizeof(tmp), "{\"v\":1,\"ts_ns\":%llu",
           (unsigned long long)nat_now_ns());
  s.append(tmp);
  s.append(",\"counters\":{");
  for (int i = 0; i < NS_COUNTER_COUNT; i++) {
    snprintf(tmp, sizeof(tmp), "%s\"%s\":%llu", i == 0 ? "" : ",",
             kCounterNames[i], (unsigned long long)combined_counter(i));
    s.append(tmp);
  }
  s.append("},\"lanes\":{");
  for (int lane = 0; lane < NL_LANE_COUNT; lane++) {
    uint64_t b[kNatHistBuckets];
    nat_stats_hist(lane, b, kNatHistBuckets);
    snprintf(tmp, sizeof(tmp), "%s\"%s\":", lane == 0 ? "" : ",",
             kLaneNames[lane]);
    s.append(tmp);
    append_buckets_json(&s, b, kNatHistBuckets);
  }
  s.append("},\"methods\":[");
  bool first = true;
  for (int i = 0; i < kNatMethodSlots; i++) {
    NatMethodCell& c = g_methods[i];
    if (c.state.load(std::memory_order_acquire) != 2) continue;
    uint64_t count = c.count.load(std::memory_order_relaxed);
    int64_t conc = c.concurrency.load(std::memory_order_relaxed);
    if (count == 0 && conc == 0) continue;  // untouched "(other)" rows
    s.append(first ? "{" : ",{");
    first = false;
    snprintf(tmp, sizeof(tmp), "\"lane\":\"%s\",\"method\":\"",
             c.lane >= 0 && c.lane < NL_LANE_COUNT ? kLaneNames[c.lane]
                                                   : "?");
    s.append(tmp);
    append_escaped_json(&s, c.method);
    snprintf(tmp, sizeof(tmp),
             "\",\"count\":%llu,\"errors\":%llu,\"concurrency\":%lld,"
             "\"max_concurrency\":%lld,\"buckets\":",
             (unsigned long long)count,
             (unsigned long long)c.errors.load(std::memory_order_relaxed),
             (long long)conc,
             (long long)c.max_concurrency.load(std::memory_order_relaxed));
    s.append(tmp);
    uint64_t b[kNatHistBuckets];
    for (int j = 0; j < kNatHistBuckets; j++) {
      b[j] = c.hist[j].load(std::memory_order_relaxed);
    }
    append_buckets_json(&s, b, kNatHistBuckets);
    s.append("}");
  }
  snprintf(tmp, sizeof(tmp),
           "],\"server\":{\"inflight\":%d,\"limit\":%d,\"draining\":%d}",
           nat_rpc_server_inflight(), nat_rpc_server_limit(),
           nat_server_draining());
  s.append(tmp);
  s.append(",\"channels\":");
  nat_channels_snapshot_json(&s);
  s.append(",\"mem\":{");
  NatResRow rows[64];
  int nres = nat_res_stats(rows, 64);
  for (int i = 0; i < nres; i++) {
    snprintf(tmp, sizeof(tmp),
             "%s\"%s\":{\"live_bytes\":%llu,\"live_objects\":%llu,"
             "\"hwm_bytes\":%llu}",
             i == 0 ? "" : ",", rows[i].name,
             (unsigned long long)rows[i].live_bytes,
             (unsigned long long)rows[i].live_objects,
             (unsigned long long)rows[i].hwm_bytes);
    s.append(tmp);
  }
  s.append("}}");
  // natcheck:allow(resacct): FFI snapshot buffer, freed by the caller
  char* buf = (char*)malloc(s.size() + 1);
  if (buf == nullptr) return -1;
  memcpy(buf, s.data(), s.size());
  buf[s.size()] = '\0';
  *out = buf;
  *out_len = s.size();
  return 0;
}

// Arm (or clear, with 0,0) this thread's ambient trace context: client
// calls issued on this thread propagate (trace_id, span_id) on the wire
// (tpu_std RpcMeta trace fields, HTTP x-bd-trace-* headers, gRPC
// metadata, kind-8 shm descriptors), so the receiving side's spans chain
// under span_id in /rpcz find_trace.
void nat_trace_set(uint64_t trace_id, uint64_t span_id) {
  tls_nat_trace.trace_id = trace_id;
  tls_nat_trace.span_id = span_id;
}

// 0 = spans off; N = sample one of every N native-handled calls.
void nat_stats_enable_spans(int every) {
  g_nat_span_every.store(every <= 0 ? 0 : (uint32_t)every,
                         std::memory_order_relaxed);
}

// Drain up to `max` span records into `out` (an array of NatSpanRec).
// Returns the number copied. Records overwritten before this drain are
// counted into nat_spans_dropped.
// no_sanitize: seqlock reader — see nat_span_submit.
__attribute__((no_sanitize("thread")))
int nat_stats_drain_spans(NatSpanRec* out, int max) {
  std::lock_guard g(g_span_drain_mu);
  uint64_t head = g_span_head.load(std::memory_order_acquire);
  if (head - g_span_next_read > kNatSpanRing) {
    uint64_t dropped = head - g_span_next_read - kNatSpanRing;
    nat_counter_add(NS_SPANS_DROPPED, dropped);
    g_span_next_read = head - kNatSpanRing;
  }
  int copied = 0;
  while (g_span_next_read < head && copied < max) {
    SpanSlot& slot = g_span_ring[g_span_next_read & (kNatSpanRing - 1)];
    uint64_t want = 2 * g_span_next_read + 2;
    if (slot.seq.load(std::memory_order_acquire) == want) {
      out[copied] = slot.rec;
      // the copy must complete BEFORE the recheck reads seq (seqlock
      // reader recipe): without the fence the loads of rec could sink
      // below the validation load
      std::atomic_thread_fence(std::memory_order_acquire);
      if (slot.seq.load(std::memory_order_relaxed) == want) {
        copied++;  // untorn: a concurrent overwrite would have bumped seq
      }
    }
    g_span_next_read++;
  }
  return copied;
}

// Test/bench hygiene: zero every cell and forget undrained spans (the
// bvar reset-between-cases discipline; production never calls this).
void nat_stats_reset() {
  // the two sections are independent; g_cell_mu must be RELEASED before
  // g_span_drain_mu is taken — the drain path holds g_span_drain_mu and
  // its dropped-span accounting can enter nat_cell_slow (g_cell_mu), so
  // nesting here would be an ABBA deadlock
  {
    std::lock_guard g(g_cell_mu);
    int n = g_ncells.load(std::memory_order_acquire);
    for (int i = 0; i <= n; i++) {
      NatStatCell* c = i < n ? g_cells[i].load(std::memory_order_acquire)
                             : &g_overflow_cell;
      if (c == nullptr) continue;
      for (int j = 0; j < NS_COUNTER_COUNT; j++) {
        c->counters[j].store(0, std::memory_order_relaxed);
      }
      for (int l = 0; l < NL_LANE_COUNT; l++) {
        for (int b = 0; b < kNatHistBuckets; b++) {
          c->hist[l][b].store(0, std::memory_order_relaxed);
        }
      }
    }
  }
  // per-method table: zero the VALUES, keep the claimed keys — in-flight
  // begin/end pairs hold slot indices across the reset. concurrency is
  // a LIVE gauge and must not be zeroed: an in-flight pair would net it
  // to a permanent -1 (its end undoes a begin the reset erased) and
  // every later max_concurrency high-water would under-report by one.
  // With balanced begin/end it already reads 0 when nothing is in
  // flight, which is the only state a between-tests reset runs in.
  for (int i = 0; i < kNatMethodSlots; i++) {
    NatMethodCell& c = g_methods[i];
    if (c.state.load(std::memory_order_acquire) != 2) continue;
    c.count.store(0, std::memory_order_relaxed);
    c.errors.store(0, std::memory_order_relaxed);
    c.max_concurrency.store(0, std::memory_order_relaxed);
    for (int b = 0; b < kNatHistBuckets; b++) {
      c.hist[b].store(0, std::memory_order_relaxed);
    }
  }
  std::lock_guard g2(g_span_drain_mu);
  g_span_next_read = g_span_head.load(std::memory_order_acquire);
}

}  // extern "C"
