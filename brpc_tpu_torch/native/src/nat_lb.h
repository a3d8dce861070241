// nat_lb — the contention-free load-balancing core of the native cluster
// (SURVEY.md §2.1/§2.6): a DoublyBufferedData server list plus the LB zoo
// selecting over it with zero locks on the read side.
//
// The reference keeps LB server lists in DoublyBufferedData so "select
// never contends with select" (load_balancer.h:72): readers see a stable
// foreground version, modifications build a background version, swap, and
// QUIESCE the readers of the old one before freeing it. The reference
// quiesces through per-thread wrapper mutexes; here the same contract is
// an epoch-parity read gate — enter() pins one of two sharded counters,
// the writer flips the parity after swapping the version pointer and
// waits for the OLD parity's pins to drain. The select hot path is one
// epoch load + one sharded fetch_add/fetch_sub pair and never blocks; the
// writer (naming refresh — Hz, not kHz) pays the wait.
//
// Memory-order note: the gate's enter/verify and the writer's
// swap/flip/sum are ALL seq_cst on purpose — the safety argument is an
// SC-order case split (a reader's pin either lands before the writer's
// drain check, which then waits for it, or after, in which case the
// reader's version load is later than the swap in the SC order and reads
// the NEW version). Weaker orders reintroduce the classic load-then-pin
// use-after-free. On x86 the cost difference vs acq_rel is nil for RMWs.
#pragma once

#include <stdint.h>
#include <string.h>

#include <atomic>
#include <map>
#include <vector>

namespace brpc_tpu {

class NatChannel;

// LB policies (global.cpp:368-376 registry, natively): parse with
// nat_lb_policy_parse; -1 = unknown name.
enum NatLbPolicy : int {
  NAT_LB_RR = 0,      // round robin
  NAT_LB_WRR,         // smooth weighted round robin (precomputed schedule)
  NAT_LB_RANDOM,      // uniform random
  NAT_LB_CHASH,       // consistent hashing with bounded remap (ketama)
  NAT_LB_LA,          // locality-aware: 1 / (ema_latency * (inflight+1))
  NAT_LB_WR,          // weighted random
  NAT_LB_DYNPART,     // _dynpart: partition scheme picked per call,
                      // weighted by live capacity (SURVEY §2.6); backend
                      // selection inside a scheme falls back to rr
};
int nat_lb_policy_parse(const char* name);

// One cluster backend. Owned by the cluster's member map; referenced by
// every ServerListVer that lists it and by every in-flight sub-call, so
// a naming removal can never free a backend under a call (refown tags
// clus.member / clus.ver / clus.call; see nat_cluster.cpp).
struct NatLbBackend {
  char endpoint[24] = {0};  // "ip:port" (the stats row key)
  char ip[16] = {0};
  int port = 0;
  // atomic: a naming refresh may re-weight a live member in place under
  // the cluster mutex while lock-free selects (wr / la) read it
  std::atomic<int> weight{1};
  char tag[16] = {0};  // written under the cluster mutex only; every
                       // reader (version build, stats) holds it too
  int part_idx = -1;   // parsed "i/n" partition tag (-1 = untagged)
  int part_total = 0;
  NatChannel* ch = nullptr;  // lazily-dialed per-backend channel

  // feedback state (locality-aware policy + the stats row)
  std::atomic<uint64_t> selects{0};
  std::atomic<uint64_t> errors{0};
  std::atomic<int64_t> inflight{0};
  std::atomic<uint64_t> ema_lat_us{10000};  // EMA latency, microseconds
  // membership flag: cleared when a naming update removes this backend
  // (old versions may still list it; selection skips removed entries)
  std::atomic<bool> removed{false};
  // transport-failure cool-down: the channel breaker only samples
  // COMPLETED calls, so a dead peer's refused dials never isolate it —
  // and a sorted member map makes one dead server a CONTIGUOUS block
  // that rr retries walk straight through. Three consecutive transport
  // failures cool the backend (200ms doubling to 3.2s); any success
  // resets. A cooled backend re-probes when the window lapses.
  std::atomic<int> fail_streak{0};
  std::atomic<int64_t> cool_until_ms{0};

  std::atomic<int> ref{0};
  void add_ref() { ref.fetch_add(1, std::memory_order_relaxed); }
  // release() lives in nat_cluster.cpp: dropping to zero closes the
  // channel and deletes — the header stays free of NatChannel details.
  void release();
};

// True when the LB may hand this backend out for a NEW call: not removed
// by naming, not breaker-isolated, not freshly lame-ducked by a draining
// peer. Defined in nat_cluster.cpp (needs NatChannel internals).
bool nat_lb_backend_usable(const NatLbBackend* b);

// EMA latency feedback (locality-aware policy): alpha = 1/8. error
// completions charge a 10x sample like the Python LocalityAwareLB.
void nat_lb_feedback(NatLbBackend* b, bool ok, uint64_t latency_us);

// Transport-failure cool-down bookkeeping (see NatLbBackend fields):
// note_failure on kEFAILEDSOCKET/kERPCTIMEDOUT completions (NOT on
// planned ELIMIT drain rejections), note_ok on any success.
void nat_lb_note_transport_failure(NatLbBackend* b);
void nat_lb_note_ok(NatLbBackend* b);

// ---------------------------------------------------------------------------
// DoublyBufferedData: one immutable server-list version + the read gate
// ---------------------------------------------------------------------------

// One immutable version of the server list, with the per-policy derived
// structures built ONCE at modification time so selection never computes
// them: the ketama ring (consistent hashing) and the smooth-wrr
// schedule. Holds one clus.ver reference per backend entry.
struct ServerListVer {
  std::vector<NatLbBackend*> backends;
  // consistent-hash ring: parallel arrays sorted by point (ketama shape,
  // kNatChashReplicas points per backend keyed by endpoint+replica, so
  // membership changes move only the departed backend's arcs — the
  // bounded-remap property: ~K/N keys move on a single removal)
  std::vector<uint64_t> ring_points;
  std::vector<uint32_t> ring_idx;
  // smooth-wrr schedule: backend indices in nginx smooth-weighted order
  // over sum(weights) slots (capped); empty unless the policy is wrr
  std::vector<uint32_t> wrr_sched;
  uint64_t total_weight = 0;
  // partition groups: part_total -> [part_idx -> member indices]
  // (precomputed for every "i/n" total present in the list)
  std::map<int, std::vector<std::vector<uint32_t>>> parts;
};

inline constexpr int kNatChashReplicas = 64;
inline constexpr int kNatWrrSchedCap = 1024;

// Build a version over `members` (no reference accounting here — the
// cluster owns the clus.ver acquire/release around build/retire).
ServerListVer* nat_lb_build_version(NatLbBackend* const* members, int n,
                                    int policy);

// The epoch-parity read gate (see file header for the SC argument).
inline constexpr int kLbGateShards = 16;

struct LbGate {
  struct alignas(64) Shard {
    std::atomic<uint64_t> cnt[2];
  };
  Shard shards[kLbGateShards];
  std::atomic<uint64_t> epoch{0};

  // Pin the current parity; returns an opaque token for exit(). The
  // verify-reload closes the pin-vs-flip race: a pin that lands after
  // the writer's drain check re-reads a flipped epoch and retries, so
  // every *verified* pin on parity P is visible to the quiesce retiring
  // P (its pin preceded the flip in SC order).
  int enter();
  void exit(int token);
  // Writer side, AFTER the version-pointer swap: flip the parity and
  // wait for the old parity's pins to drain. Single-writer only (the
  // cluster serializes updates under its mutex); sched_yield spin — the
  // wait is bounded by reader critical sections (microseconds).
  void quiesce();
};

// Select a backend index from `v` (or -1 when nothing usable): the zero-
// lock read path. `cursor` is the cluster's shared rr/wrr cursor;
// `request_code` keys the consistent-hash policy; `exclude` skips
// already-tried backends (failover retry) unless that would empty the
// candidate set.
int nat_lb_select(const ServerListVer* v, int policy,
                  std::atomic<uint64_t>* cursor, uint64_t request_code,
                  NatLbBackend* const* exclude, int n_exclude);

// Deterministic 64-bit point hash shared by the ring builder and the
// remap property test (FNV-1a over the endpoint, mixed per replica).
uint64_t nat_lb_chash_point(const char* endpoint, uint32_t replica);

// _dynpart scheme capacity: usable-backend count of the part_total
// scheme, or 0 when ANY of its partition groups has no usable member —
// a half-dead scheme must lose to a complete one during a resize, or
// the pick itself manufactures failed sub-calls.
int nat_lb_dynpart_capacity(const ServerListVer* v, int part_total);

// _dynpart scheme pick (DynPartLB.select_server natively): schemes walk
// in ascending part_total order, weighted random by capacity with the
// point x01 in [0,1) supplied by the caller — production passes
// nat_lb_rand01(), the equivalence probe passes a fixed point so the
// Python DynPartLB walk lands on the same scheme. Returns the chosen
// part_total, or 0 when no scheme has capacity.
int nat_lb_dynpart_pick(const ServerListVer* v, double x01);

// Uniform [0,1) from the per-thread LB xorshift stream.
double nat_lb_rand01();

}  // namespace brpc_tpu
