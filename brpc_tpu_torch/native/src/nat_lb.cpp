// nat_lb — DoublyBufferedData read gate + the native LB policy zoo.
// See nat_lb.h for the design map and the seq_cst safety argument.
#include "nat_lb.h"

#include <sched.h>

#include <algorithm>

#include "nat_stats.h"

namespace brpc_tpu {

int nat_lb_policy_parse(const char* name) {
  if (name == nullptr || name[0] == '\0') return NAT_LB_RR;
  if (strcmp(name, "rr") == 0) return NAT_LB_RR;
  if (strcmp(name, "wrr") == 0) return NAT_LB_WRR;
  if (strcmp(name, "random") == 0) return NAT_LB_RANDOM;
  if (strcmp(name, "wr") == 0) return NAT_LB_WR;
  if (strcmp(name, "la") == 0) return NAT_LB_LA;
  if (strcmp(name, "_dynpart") == 0) return NAT_LB_DYNPART;
  // both reference hash registrations map onto the one native ring
  if (strcmp(name, "c_hash") == 0 || strcmp(name, "c_murmurhash") == 0 ||
      strcmp(name, "c_md5") == 0) {
    return NAT_LB_CHASH;
  }
  return -1;
}

void nat_lb_feedback(NatLbBackend* b, bool ok, uint64_t latency_us) {
  if (!ok) {
    b->errors.fetch_add(1, std::memory_order_relaxed);
    latency_us *= 10;  // error sample penalty (LocalityAwareLB.feedback)
  }
  if (latency_us == 0) latency_us = 1;
  uint64_t cur = b->ema_lat_us.load(std::memory_order_relaxed);
  // alpha = 1/8; CAS loop so concurrent completers don't lose updates
  // (bounded: one extra lap per racing completer)
  while (true) {
    uint64_t next = cur - cur / 8 + latency_us / 8;
    if (next == 0) next = 1;
    if (b->ema_lat_us.compare_exchange_weak(cur, next,
                                            std::memory_order_relaxed)) {
      break;
    }
  }
}

void nat_lb_note_transport_failure(NatLbBackend* b) {
  int s = b->fail_streak.fetch_add(1, std::memory_order_relaxed) + 1;
  if (s >= 3) {
    int shift = s - 3 < 4 ? s - 3 : 4;
    int64_t window_ms = 200ll << shift;  // 200ms .. 3.2s
    b->cool_until_ms.store(
        (int64_t)(nat_now_ns() / 1000000ull) + window_ms,
        std::memory_order_relaxed);
  }
}

void nat_lb_note_ok(NatLbBackend* b) {
  if (b->fail_streak.load(std::memory_order_relaxed) != 0) {
    b->fail_streak.store(0, std::memory_order_relaxed);
    b->cool_until_ms.store(0, std::memory_order_relaxed);
  }
}

// ---------------------------------------------------------------------------
// version builder
// ---------------------------------------------------------------------------

uint64_t nat_lb_chash_point(const char* endpoint, uint32_t replica) {
  // FNV-1a over the endpoint string, then one mix round per replica —
  // points of one backend spread uniformly, points of different
  // backends are independent (the bounded-remap precondition).
  uint64_t h = 1469598103934665603ull;
  for (const char* p = endpoint; *p != '\0'; p++) {
    h = (h ^ (uint64_t)(uint8_t)*p) * 1099511628211ull;
  }
  return nat_mix64(h ^ ((uint64_t)replica << 32 | replica));
}

ServerListVer* nat_lb_build_version(NatLbBackend* const* members, int n,
                                    int policy) {
  ServerListVer* v = new ServerListVer();
  v->backends.assign(members, members + n);
  for (int i = 0; i < n; i++) {
    int w = members[i]->weight.load(std::memory_order_relaxed);
    v->total_weight += (uint64_t)(w > 0 ? w : 1);
    if (members[i]->part_total > 0) {
      auto& groups = v->parts[members[i]->part_total];
      if ((int)groups.size() < members[i]->part_total) {
        groups.resize(members[i]->part_total);
      }
      if (members[i]->part_idx >= 0 &&
          members[i]->part_idx < members[i]->part_total) {
        groups[members[i]->part_idx].push_back((uint32_t)i);
      }
    }
  }
  if (policy == NAT_LB_CHASH && n > 0) {
    std::vector<std::pair<uint64_t, uint32_t>> pts;
    pts.reserve((size_t)n * kNatChashReplicas);
    for (int i = 0; i < n; i++) {
      for (uint32_t r = 0; r < (uint32_t)kNatChashReplicas; r++) {
        pts.emplace_back(nat_lb_chash_point(members[i]->endpoint, r),
                         (uint32_t)i);
      }
    }
    std::sort(pts.begin(), pts.end());
    v->ring_points.reserve(pts.size());
    v->ring_idx.reserve(pts.size());
    for (const auto& p : pts) {
      v->ring_points.push_back(p.first);
      v->ring_idx.push_back(p.second);
    }
  }
  if (policy == NAT_LB_WRR && n > 0) {
    // nginx smooth weighted RR, expanded into a cyclic schedule. When
    // the summed weights exceed the schedule cap the weights are
    // RESCALED (each clamped to >= 1) instead of the schedule being
    // truncated — a truncated schedule would permanently starve
    // low-weight backends whose first slot lies past the cap.
    std::vector<int64_t> w((size_t)n);
    uint64_t total = 0;
    for (int i = 0; i < n; i++) {
      int raw = members[i]->weight.load(std::memory_order_relaxed);
      w[(size_t)i] = raw > 0 ? raw : 1;
      total += (uint64_t)w[(size_t)i];
    }
    if (total > (uint64_t)kNatWrrSchedCap) {
      uint64_t scaled_total = 0;
      for (int i = 0; i < n; i++) {
        int64_t sw = (int64_t)((uint64_t)w[(size_t)i] *
                               (uint64_t)kNatWrrSchedCap / total);
        w[(size_t)i] = sw > 0 ? sw : 1;
        scaled_total += (uint64_t)w[(size_t)i];
      }
      total = scaled_total;
    }
    std::vector<int64_t> cur((size_t)n, 0);
    v->wrr_sched.reserve((size_t)total);
    for (uint64_t s = 0; s < total; s++) {
      int best = 0;
      for (int i = 0; i < n; i++) {
        cur[(size_t)i] += w[(size_t)i];
        if (cur[(size_t)i] > cur[(size_t)best]) best = i;
      }
      cur[(size_t)best] -= (int64_t)total;
      v->wrr_sched.push_back((uint32_t)best);
    }
  }
  return v;
}

// ---------------------------------------------------------------------------
// read gate
// ---------------------------------------------------------------------------

static std::atomic<uint32_t> g_gate_tid_seq{0};
static thread_local uint32_t tls_gate_shard = UINT32_MAX;

static inline uint32_t gate_shard() {
  uint32_t s = tls_gate_shard;
  if (s == UINT32_MAX) {
    s = g_gate_tid_seq.fetch_add(1, std::memory_order_relaxed) %
        (uint32_t)kLbGateShards;
    tls_gate_shard = s;
  }
  return s;
}

int LbGate::enter() {
  uint32_t sh = gate_shard();
  while (true) {
    uint32_t e =
        (uint32_t)(epoch.load(std::memory_order_seq_cst) & 1ull);
    shards[sh].cnt[e].fetch_add(1, std::memory_order_seq_cst);
    if ((uint32_t)(epoch.load(std::memory_order_seq_cst) & 1ull) == e) {
      return (int)((sh << 1) | e);  // pinned the CURRENT parity
    }
    // raced a writer's flip: the pin may have landed after its drain
    // check — undo and pin the new parity instead
    shards[sh].cnt[e].fetch_sub(1, std::memory_order_seq_cst);
  }
}

void LbGate::exit(int token) {
  shards[token >> 1].cnt[token & 1].fetch_sub(1,
                                              std::memory_order_seq_cst);
}

void LbGate::quiesce() {
  uint64_t old = epoch.fetch_add(1, std::memory_order_seq_cst) & 1ull;
  while (true) {
    uint64_t pins = 0;
    for (int s = 0; s < kLbGateShards; s++) {
      pins += shards[s].cnt[old].load(std::memory_order_seq_cst);
    }
    if (pins == 0) return;
    sched_yield();  // bounded by reader critical sections (no sleep:
                    // quiesce may run under the cluster mutex)
  }
}

// ---------------------------------------------------------------------------
// selection
// ---------------------------------------------------------------------------

static thread_local uint64_t tls_lb_rand = 0;

static inline uint64_t lb_rand() {
  uint64_t x = tls_lb_rand;
  if (x == 0) {
    x = nat_mix64((uint64_t)(uintptr_t)&tls_lb_rand ^ nat_now_ns());
  }
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  tls_lb_rand = x;
  return x;
}

double nat_lb_rand01() {
  return (double)(lb_rand() >> 11) / (double)(1ull << 53);
}

int nat_lb_dynpart_capacity(const ServerListVer* v, int part_total) {
  auto it = v->parts.find(part_total);
  if (it == v->parts.end()) return 0;
  const std::vector<std::vector<uint32_t>>& groups = it->second;
  if ((int)groups.size() < part_total) return 0;
  int cap = 0;
  for (int p = 0; p < part_total; p++) {
    int live = 0;
    for (uint32_t idx : groups[(size_t)p]) {
      if (nat_lb_backend_usable(v->backends[idx])) live++;
    }
    if (live == 0) return 0;  // incomplete scheme: unusable as a whole
    cap += live;
  }
  return cap;
}

int nat_lb_dynpart_pick(const ServerListVer* v, double x01) {
  // DynPartLB.select_server natively: capacities sampled ONCE into a
  // local walk (a concurrent membership/usability change cannot skew
  // the pick), weighted random over the ascending-total scheme order —
  // the same order the Python channel registers its schemes in.
  int totals[64];
  int caps[64];
  int n = 0;
  long long sum = 0;
  for (const auto& kv : v->parts) {
    if (n >= 64) break;
    int cap = nat_lb_dynpart_capacity(v, kv.first);
    if (cap <= 0) continue;
    totals[n] = kv.first;
    caps[n] = cap;
    sum += cap;
    n++;
  }
  if (n == 0) return 0;
  double x = x01 * (double)sum;
  double acc = 0.0;
  for (int i = 0; i < n; i++) {
    acc += (double)caps[i];
    if (x <= acc) return totals[i];
  }
  return totals[n - 1];
}

static inline bool lb_excluded(const NatLbBackend* b,
                               NatLbBackend* const* exclude,
                               int n_exclude) {
  for (int i = 0; i < n_exclude; i++) {
    if (exclude[i] == b) return true;
  }
  return false;
}

// Candidate filter shared by every policy: alive per the usable
// predicate, and not in the caller's tried set — unless exclusion would
// empty the candidates (excluding everything beats returning nothing,
// the Python _usable contract).
static int lb_scan_from(const ServerListVer* v, size_t start,
                        NatLbBackend* const* exclude, int n_exclude) {
  const size_t n = v->backends.size();
  int fallback = -1;
  for (size_t step = 0; step < n; step++) {
    size_t i = (start + step) % n;
    NatLbBackend* b = v->backends[i];
    if (!nat_lb_backend_usable(b)) continue;
    if (lb_excluded(b, exclude, n_exclude)) {
      if (fallback < 0) fallback = (int)i;
      continue;
    }
    return (int)i;
  }
  return fallback;
}

int nat_lb_select(const ServerListVer* v, int policy,
                  std::atomic<uint64_t>* cursor, uint64_t request_code,
                  NatLbBackend* const* exclude, int n_exclude) {
  const size_t n = v->backends.size();
  if (n == 0) return -1;
  switch (policy) {
    case NAT_LB_WRR: {
      const size_t m = v->wrr_sched.size();
      if (m == 0) break;  // degenerate: fall through to rr below
      // walk the precomputed schedule from the shared cursor; skip
      // unusable/excluded entries (same fallback contract as scan)
      uint64_t c = cursor->fetch_add(1, std::memory_order_relaxed);
      int fallback = -1;
      for (size_t step = 0; step < m; step++) {
        uint32_t idx = v->wrr_sched[(c + step) % m];
        NatLbBackend* b = v->backends[idx];
        if (!nat_lb_backend_usable(b)) continue;
        if (lb_excluded(b, exclude, n_exclude)) {
          if (fallback < 0) fallback = (int)idx;
          continue;
        }
        return (int)idx;
      }
      return fallback;
    }
    case NAT_LB_RANDOM:
      return lb_scan_from(v, (size_t)(lb_rand() % n), exclude, n_exclude);
    case NAT_LB_CHASH: {
      if (v->ring_points.empty()) break;
      uint64_t point = nat_mix64(request_code);
      size_t lo = std::upper_bound(v->ring_points.begin(),
                                   v->ring_points.end(), point) -
                  v->ring_points.begin();
      const size_t m = v->ring_points.size();
      int fallback = -1;
      for (size_t step = 0; step < m; step++) {
        uint32_t idx = v->ring_idx[(lo + step) % m];
        NatLbBackend* b = v->backends[idx];
        if (!nat_lb_backend_usable(b)) continue;
        if (lb_excluded(b, exclude, n_exclude)) {
          if (fallback < 0) fallback = (int)idx;
          continue;
        }
        return (int)idx;
      }
      return fallback;
    }
    case NAT_LB_LA: {
      // weighted random by weight / (ema_latency * (inflight + 1)),
      // fixed-point over one O(n) scan (the locality-aware shape).
      double total = 0.0;
      double w[512];
      const size_t cap = n < 512 ? n : 512;  // scan window; beyond it
      // the tail competes via the rr fallback (a 1000-backend cluster
      // on the la policy still balances — the window rotates)
      size_t start = cap < n ? (size_t)(lb_rand() % n) : 0;
      int map[512];
      size_t cand = 0;
      for (size_t step = 0; step < n && cand < cap; step++) {
        size_t i = (start + step) % n;
        NatLbBackend* b = v->backends[i];
        if (!nat_lb_backend_usable(b) ||
            lb_excluded(b, exclude, n_exclude)) {
          continue;
        }
        uint64_t ema = b->ema_lat_us.load(std::memory_order_relaxed);
        int64_t infl = b->inflight.load(std::memory_order_relaxed);
        if (ema == 0) ema = 1;
        if (infl < 0) infl = 0;
        int bw = b->weight.load(std::memory_order_relaxed);
        double wi = (double)(bw > 0 ? bw : 1) /
                    ((double)ema * (double)(infl + 1));
        w[cand] = wi;
        map[cand] = (int)i;
        total += wi;
        cand++;
      }
      if (cand == 0) {
        return lb_scan_from(v, 0, exclude, 0);  // exclusion fallback
      }
      double x = (double)(lb_rand() >> 11) / (double)(1ull << 53) * total;
      double acc = 0.0;
      for (size_t i = 0; i < cand; i++) {
        acc += w[i];
        if (x <= acc) return map[i];
      }
      return map[cand - 1];
    }
    case NAT_LB_WR: {
      if (v->total_weight == 0) break;
      uint64_t x = lb_rand() % v->total_weight;
      uint64_t acc = 0;
      size_t start = 0;
      for (size_t i = 0; i < n; i++) {
        int bw = v->backends[i]->weight.load(std::memory_order_relaxed);
        acc += (uint64_t)(bw > 0 ? bw : 1);
        if (x < acc) {
          start = i;
          break;
        }
      }
      return lb_scan_from(v, start, exclude, n_exclude);
    }
    default:
      break;
  }
  // rr (and every degenerate fall-through): shared-cursor scan
  uint64_t c = cursor->fetch_add(1, std::memory_order_relaxed);
  return lb_scan_from(v, (size_t)(c % n), exclude, n_exclude);
}

}  // namespace brpc_tpu
