// nat_stats — native-runtime observability substrate.
//
// The bvar discipline (SURVEY.md §1 "lock-light metrics: thread-local
// agents + background sampler", reducer.h / percentile.h) brought to the
// C++ hot path: every reading thread / fiber worker / py-lane pthread owns
// one cache-line-aligned NatStatCell holding monotonic counters and
// fixed-bucket log2 latency histograms. The write side is single-writer
// relaxed stores (no lock, no RMW contention); readers combine all cells
// on demand, exactly like bvar's AgentCombiner. Span records for
// native-handled calls go into a bounded global ring (the bvar::Collector
// budget analog, collector.h:40: sampling keeps the hot-path cost fixed
// no matter the traffic) that the Python side drains into /rpcz.
#pragma once

#include <stdint.h>
#include <string.h>
#include <time.h>

#include <atomic>
#include <string>

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// counter ids — one flat namespace, names exported via nat_stats C API
// ---------------------------------------------------------------------------

enum NatCounterId : int {
  NS_SOCK_READ_BYTES = 0,   // bytes drained from connection fds / ring bufs
  NS_SOCK_WRITE_BYTES,      // bytes the kernel accepted (writev / ring send)
  NS_CONNECTIONS_ACCEPTED,  // server-side accepts
  NS_TPU_STD_MSGS_IN,       // complete tpu_std request frames parsed
  NS_TPU_STD_RESPONSES_OUT, // tpu_std response frames built
  NS_TPU_STD_ERRORS,        // protocol errors on the tpu_std cut
  NS_HTTP_MSGS_IN,          // complete native-parsed HTTP/1.1 requests
  NS_HTTP_RESPONSES_OUT,    // HTTP responses queued (native + py lanes)
  NS_HTTP_ERRORS,           // HTTP session protocol errors
  NS_H2_MSGS_IN,            // gRPC-over-h2 request streams dispatched
  NS_H2_RESPONSES_OUT,      // gRPC responses framed
  NS_H2_ERRORS,             // h2 session protocol errors
  NS_REDIS_MSGS_IN,         // complete RESP commands parsed
  NS_REDIS_RESPONSES_OUT,   // RESP replies queued
  NS_REDIS_ERRORS,          // RESP protocol errors
  NS_CLIENT_CALLS,          // calls begun on native channels (all protocols)
  NS_CLIENT_RESPONSES,      // completed calls (first completion wins)
  NS_CLIENT_ERRORS,         // fail_all-completed calls (socket death)
  NS_PY_DISPATCHES,         // requests handed to the Python lane
  NS_PY_QUEUE_DEPTH,        // gauge: py-lane MPSC queue depth right now
  NS_SPANS_DROPPED,         // span ring overwrites before a drain
  NS_FAULTS_INJECTED,       // natfault table hits (all sites)
  NS_ELIMIT_REJECTS,        // admission-control ELIMIT wire rejections
  NS_QUEUE_DEADLINE_DROPS,  // requests expired in the py queue (ELIMIT)
  NS_RETRY_BUDGET_EXHAUSTED,// retries suppressed by the channel budget
  NS_BREAKER_ISOLATIONS,    // native circuit-breaker trips
  NS_BREAKER_REVIVALS,      // breaker resets after a successful re-dial
  NS_DISP_WAKEUPS,          // dispatcher epoll rounds that delivered events
  NS_WSQ_STEALS,            // fiber runqueue steals (cross-core balance)
  NS_WORKER_PARKS,          // scheduler worker park attempts (idle shape)
  NS_SQPOLL_RINGS,          // gauge: io_uring rings running SQPOLL now
  NS_QUIESCE_LAME_DUCK_SENT,// lame-duck signals emitted (GOAWAY / SHUTDOWN
                            // bit / Connection: close / RESP close armed)
  NS_QUIESCE_DRAINED_OK,    // quiesce drains that completed in deadline
  NS_QUIESCE_DRAIN_DEADLINE_DROPS, // admitted requests 503'd at the
                            // drain deadline (stragglers, never reset)
  NS_QUIESCE_DRAINING_REDIALS, // client detaches from a lame-duck peer
                            // (next call re-dials / re-balances)
  // traffic flight recorder (nat_dump.cpp / nat_replay.cpp): monotonic
  // cross-window totals; per-window figures ride nat_dump_status
  NS_DUMP_SAMPLES,          // requests captured into the dump rings
  NS_DUMP_RECORDS_WRITTEN,  // records persisted to recordio files
  NS_DUMP_BYTES_WRITTEN,    // capture file bytes (headers+meta+payload)
  NS_DUMP_DROPS,            // ring-full / cell-pool drops
  NS_DUMP_OVERSIZE,         // payloads past the cap, skipped whole
  NS_DUMP_ROTATIONS,        // capture file generation rollovers
  NS_REPLAY_CALLS,          // replay calls fired (all lanes)
  NS_REPLAY_ERRORS,         // replay calls that failed
  // native fan-out cluster (nat_cluster.cpp / nat_lb.cpp)
  NS_LB_SELECTS,            // LB selections (selective picks + fan subs)
  NS_FANOUT_CALLS,          // cluster verbs begun (selective/parallel/
                            // partition)
  NS_FANOUT_SUBCALLS,       // sub-calls issued by the fan-out verbs
  NS_FANOUT_SUBCALL_ERRORS, // sub-calls that completed with an error
  NS_FANOUT_FAILS,          // verbs that failed their fail_limit
  NS_CLUSTER_UPDATES,       // naming-feed server-list swaps
  NS_CLUSTER_BACKENDS_ADDED,   // backends opened by naming additions
  NS_CLUSTER_BACKENDS_REMOVED, // backends retired by naming removals

  NS_FABRIC_PUSHES,         // kind-8 tensor records pushed onto the
                            // descriptor-ring fabric (both directions)
  NS_FABRIC_TAKES,          // fabric records taken as receiver leases
  NS_FABRIC_RECOVER_DROPS,  // fabric records discarded by dead-producer
                            // slot recovery (sender died mid-stream)
  NS_BULK_FILL_FRAMES,      // tpu_std frames whose payload landed in one
                            // pooled bulk block via read-side fill mode
  NS_STATS_SNAPSHOTS,       // builtin.stats snapshots built (the fleet
                            // scrape counter — a collector at 1Hz shows
                            // here, so overhead questions are answerable)
  NS_DYNPART_RESIZES,       // server-list publishes that changed the
                            // partition-scheme layout (dynpart resize)
  NS_AUTOSCALE_GROWS,       // autoscaler grow actions applied (bumped
                            // from the fleet controller via counter_bump)
  NS_AUTOSCALE_SHRINKS,     // autoscaler shrink actions applied
  NS_AUTOSCALE_BLOCKED,     // autoscaler actions withheld (SLO burning,
                            // min/max bound, members still draining)
  NS_COUNTER_COUNT,
};

// latency-histogram lanes (per-call ns, parse-complete -> response-write)
enum NatLatLane : int {
  NL_ECHO = 0,  // tpu_std native handler calls
  NL_HTTP,      // native-usercode HTTP handler calls
  NL_REDIS,     // native redis store command execution
  NL_GRPC,      // native-handler gRPC-over-h2 calls
  NL_CLIENT,    // client call round trip (begin_call -> completion)
  NL_WORKER,    // shm worker-process usercode (take -> respond)
  NL_LANE_COUNT,
};

// log2 ns buckets: bucket b holds values in [2^(b-1), 2^b) ns (b=0 holds
// 0..1ns); 44 buckets cover ~17 seconds — combined on demand, percentiles
// interpolated inside the winning bucket (percentile.h's role with a
// deterministic histogram instead of a reservoir).
inline constexpr int kNatHistBuckets = 44;

struct alignas(64) NatStatCell {
  // single-writer discipline: only the owning thread stores (relaxed
  // load+store, no locked RMW); combiners read with relaxed loads.
  std::atomic<uint64_t> counters[NS_COUNTER_COUNT];
  std::atomic<uint64_t> hist[NL_LANE_COUNT][kNatHistBuckets];
};

NatStatCell* nat_cell_slow();  // registers this thread's cell
extern thread_local NatStatCell* tls_nat_cell;

inline NatStatCell* nat_cell() {
  NatStatCell* c = tls_nat_cell;
  return c != nullptr ? c : nat_cell_slow();
}

inline void nat_counter_add(int id, uint64_t v) {
  std::atomic<uint64_t>& c = nat_cell()->counters[id];
  c.store(c.load(std::memory_order_relaxed) + v, std::memory_order_relaxed);
}

inline uint64_t nat_now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// splitmix64 finalizer — the one mixing function for everything that
// needs a cheap deterministic hash (fault-schedule decisions, backoff
// jitter dither). Pure function of its input.
inline uint64_t nat_mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

inline int nat_hist_bucket(uint64_t ns) {
  if (ns == 0) return 0;
  int b = 64 - __builtin_clzll(ns);  // floor(log2(ns)) + 1
  return b < kNatHistBuckets ? b : kNatHistBuckets - 1;
}

inline void nat_lat_record(int lane, uint64_t ns) {
  std::atomic<uint64_t>& c = nat_cell()->hist[lane][nat_hist_bucket(ns)];
  c.store(c.load(std::memory_order_relaxed) + 1, std::memory_order_relaxed);
}

// Quantile (0..1) over a log2 histogram, interpolated within the
// winning bucket; ns, 0.0 when empty. ONE implementation shared by the
// lane exports, the per-method exports and the replay client — the
// interpolation must never diverge between them. Defined nat_stats.cpp.
double nat_hist_quantile(const uint64_t* buckets, int nb, double q);

// Channel-registry JSON rows for the builtin.stats snapshot (defined in
// nat_channel.cpp beside the registry): appends a JSON array of the
// process's open client channels — peer, protocol, breaker and
// lame-duck state, retry budget. The snapshot builder (nat_stats.cpp)
// must stay channel-layout-blind, so the row rendering lives with the
// fields it reads.
void nat_channels_snapshot_json(std::string* out);

// ---------------------------------------------------------------------------
// per-method stats — the native MethodStatus table (details/method_status.h
// role): one slot per (lane, method) holding call count, error count, a
// log2 latency histogram and current/max concurrency, recorded at the
// same call sites that feed the NL_* lanes (nat_messenger / nat_http /
// nat_h2 / nat_redis native handlers + the shm worker emit path).
// Fixed open-addressed pool; slots are claimed once and never freed, so a
// returned index stays valid forever (reset zeroes values, keeps keys).
// ---------------------------------------------------------------------------

inline constexpr int kNatMethodSlots = 128;
inline constexpr int kNatMethodNameLen = 52;

// Snapshot row (ctypes mirror in brpc_tpu/native, layout in the ABI
// manifest): values only — the histogram is fetched per (lane, method).
struct NatMethodStatRow {
  uint64_t count;            // completed calls (qps source)
  uint64_t errors;           // completions with a nonzero error/5xx
  int64_t concurrency;       // running right now
  int64_t max_concurrency;   // high-water mark since start/reset
  int32_t lane;              // NatLatLane of the recording site
  char method[kNatMethodNameLen];
};

// Find-or-create the slot for (lane, method); when the table is full
// the lane's "(other)" overflow row is returned (method names arrive
// off the wire, so exhaustion must degrade attribution, not stop it).
int nat_method_idx(int lane, const char* method, size_t len);
// Lookup-only: -1 when (lane, method) has no slot; never claims one.
int nat_method_find(int lane, const char* method, size_t len);
// One call entered usercode on this method (concurrency++, high-water).
void nat_method_begin(int idx);
// One call completed: concurrency--, count++, errors+=, histogram.
void nat_method_end(int idx, uint64_t latency_ns, bool error);
// Undo a begin with no completed call (shm offer that fell back to the
// in-process lane): concurrency-- only.
void nat_method_abort(int idx);

// ---------------------------------------------------------------------------
// per-connection snapshot row (native /connections): counters live on the
// NatSocket itself (single-ish writers, relaxed atomics); the snapshot
// walks the registry and fills one row per live socket.
// ---------------------------------------------------------------------------

struct NatConnRow {
  uint64_t sock_id;
  uint64_t in_bytes;         // bytes drained off this fd / ring buffers
  uint64_t out_bytes;        // bytes the kernel accepted
  uint64_t in_msgs;          // protocol messages parsed on this socket
  uint64_t out_msgs;         // protocol messages emitted on this socket
  uint64_t read_calls;       // read()/readv/ring-recv completions
  uint64_t write_calls;      // writev/ring-send completions
  uint64_t unwritten_bytes;  // queued on the write stack, not yet accepted
  uint64_t mem_bytes;        // approximate per-socket memory: unwritten
                             // write-stack bytes + read-buffer bytes +
                             // reorder-window parked bytes (ISSUE 14's
                             // /connections memory column)
  int32_t fd;
  int32_t disp_idx;          // owning dispatcher loop (-1 = none)
  int32_t server_side;       // 1 = accepted, 0 = dialed
  char protocol[12];         // sniffed session kind ("tpu_std", "http"...)
  char remote[24];           // "ip:port" peer address
};

// ---------------------------------------------------------------------------
// per-backend cluster snapshot row (nat_cluster.cpp): one row per member
// of a native cluster — the /status cluster table and the labeled
// nat_cluster_* Prometheus rows ride this.
// ---------------------------------------------------------------------------

struct NatClusterRow {
  uint64_t selects;         // times the LB handed this backend out
  uint64_t errors;          // sub-calls/attempts that failed on it
  int64_t inflight;         // in-flight sub-calls right now
  uint64_t ema_latency_us;  // locality-aware EMA latency feedback
  int32_t weight;
  int32_t breaker_open;     // 1 = breaker-isolated (PR-5 per-channel)
  int32_t lame_duck;        // 1 = peer recently signaled drain (PR-8)
  int32_t part_index;       // parsed "i/n" partition tag (-1 untagged)
  int32_t part_total;
  char endpoint[24];        // "ip:port"
  char tag[16];             // raw naming tag
};

// ---------------------------------------------------------------------------
// lock-contention per-rank totals (nat_prof.cpp's mutex-wait profiler):
// always-on cheap accounting on the CONTENDED path only — every NatMutex
// lock() that fails its try_lock measures the blocking wait and feeds its
// rank's row; stack sampling on top is armed via nat_mu_prof_start.
// ---------------------------------------------------------------------------

struct NatLockRankRow {
  uint64_t waits;    // contended acquisitions observed
  uint64_t wait_us;  // total microseconds spent blocked
  int32_t rank;      // nat_lockrank.h rank value
  char name[20];     // human name of the rank ("sock.epoll", ...)
};

// ---------------------------------------------------------------------------
// span ring — fixed-size records of native-handled calls, drained by the
// Python side into the shared /rpcz store (span.h:47-224 shape, with the
// Collector budget expressed as a sampling stride).
// ---------------------------------------------------------------------------

inline constexpr uint32_t kNatSpanRingBits = 12;
inline constexpr uint32_t kNatSpanRing = 1u << kNatSpanRingBits;  // 4096

struct NatSpanRec {
  uint64_t trace_id;
  uint64_t span_id;
  uint64_t parent_span_id;  // 0 = root (no known parent)
  uint64_t sock_id;
  // monotonic ns timeline: recv <= parse <= dispatch <= write
  uint64_t recv_ns;      // request fully buffered / stream complete
  uint64_t parse_ns;     // protocol parse done, usercode about to run
  uint64_t dispatch_ns;  // usercode returned
  uint64_t write_ns;     // response bytes queued to the socket
  int32_t protocol;      // a NatLatLane value
  int32_t error_code;
  uint32_t req_bytes;
  uint32_t resp_bytes;
  char method[48];       // NUL-terminated, truncated
};

// 0 = spans off (default for bare native runtimes); N = record one of
// every N native-handled calls (the Python mount sets this from the
// rpcz flags).
extern std::atomic<uint32_t> g_nat_span_every;

// True when THIS call should be recorded (per-thread stride counter —
// check it first, it is one branch in the common off case).
bool nat_span_tick();
void nat_span_submit(const NatSpanRec& rec);

// 63-bit xorshift id (random.getrandbits(63) analog): span/trace ids are
// masked to 63 bits so they survive the proto int64 varint round trip
// without flipping sign on the Python side.
uint64_t nat_span_id63();

// Fill + submit helper for the server-side lanes. trace_id == 0 starts a
// fresh trace; parent_span_id is the CALLER's span id from the wire (the
// RpcMeta trace fields / x-bd-trace-* headers / gRPC metadata).
void nat_span_record(int lane, uint64_t sock_id, const char* method,
                     size_t method_len, uint64_t recv_ns, uint64_t parse_ns,
                     uint64_t dispatch_ns, uint64_t write_ns,
                     int32_t error_code, uint32_t req_bytes,
                     uint32_t resp_bytes, uint64_t trace_id = 0,
                     uint64_t parent_span_id = 0);

// ---------------------------------------------------------------------------
// trace context — thread-local (trace_id, span_id) armed by the embedder
// (nat_trace_set) before issuing client calls on this thread; the client
// lanes stamp it into the wire metadata so /rpcz find_trace can stitch
// client -> server -> worker chains across processes (span.h:76,116's
// tls_bls parenting, carried over the FFI boundary).
// ---------------------------------------------------------------------------

struct NatTraceCtx {
  uint64_t trace_id = 0;  // 0 = no ambient trace
  uint64_t span_id = 0;   // parent span for calls issued on this thread
};
extern thread_local NatTraceCtx tls_nat_trace;

// Gauges: computed at snapshot time (PassiveStatus discipline) — cells
// contribute nothing; the registered callback is the value.
void nat_stats_register_gauge(int counter_id, uint64_t (*fn)());

}  // namespace brpc_tpu
