// nat_fault — spec parser, seeded decision function, and the extern "C"
// configuration surface. See nat_fault.h for the grammar and the
// determinism contract.
#include "nat_fault.h"

#include <errno.h>
#include <stdlib.h>
#include <string.h>

#include <chrono>
#include <string>
#include <thread>

#include "nat_api.h"
#include "nat_stats.h"

namespace brpc_tpu {

std::atomic<uint32_t> g_nat_fault_on{0};

namespace {

constexpr int kMaxRules = 16;

struct FaultRule {
  int site = 0;
  int action = NF_NONE;
  int err = 0;
  int delay_ms = 0;
  uint64_t nth = 0;    // fire exactly on op N (1-based); 0 = off
  uint64_t every = 0;  // fire on every Nth op; 0 = off
  uint32_t p_bits = 0; // probability threshold vs a 32-bit hash; 0 = off
  bool always = false; // no selector token: every op fires
};

struct FaultTable {
  uint64_t seed = 0;
  int nrules = 0;
  FaultRule rules[kMaxRules];
  // per-site op counters live WITH the rules: the table-pointer swap
  // atomically replaces both, so an in-flight hook can never charge a
  // fresh (zeroed) counter against a previous spec's rules — nth=
  // schedules are exact per installed table.
  std::atomic<uint64_t> ops[NF_SITE_COUNT] = {};
};

// Tables are heap-allocated and LEAKED on reconfigure: a hook that
// loaded the pointer may still be walking the rules while a later
// configure publishes a replacement, and freeing (or reusing a fixed
// double buffer — two back-to-back configures would recycle the buffer
// a reader still holds) would be a use-after-free/data race. Configure
// traffic is test-bounded and a table is ~1KB; bounded leak, zero race
// (the repo's leak-on-purpose discipline).
std::atomic<FaultTable*> g_active_table{nullptr};

std::atomic<uint64_t> g_injected{0};

int errno_by_name(const char* s) {
  if (strcmp(s, "ECONNRESET") == 0) return ECONNRESET;
  if (strcmp(s, "EINTR") == 0) return EINTR;
  if (strcmp(s, "EPIPE") == 0) return EPIPE;
  if (strcmp(s, "EAGAIN") == 0) return EAGAIN;
  if (strcmp(s, "ETIMEDOUT") == 0) return ETIMEDOUT;
  if (strcmp(s, "ECONNREFUSED") == 0) return ECONNREFUSED;
  if (strcmp(s, "EIO") == 0) return EIO;
  int v = atoi(s);
  return v > 0 ? v : 0;
}

int site_by_name(const std::string& s) {
  if (s == "read") return NF_READ;
  if (s == "write") return NF_WRITE;
  if (s == "connect") return NF_CONNECT;
  if (s == "doorbell") return NF_DOORBELL;
  if (s == "worker") return NF_WORKER;
  if (s == "accept") return NF_ACCEPT;
  if (s == "shutdown") return NF_SHUTDOWN;
  return -1;
}

// One action token ("short", "kill@7", "drop", ...). Returns the action
// or NF_NONE when the token is not an action name; `nth` gets the @N
// suffix when present.
int action_token(const std::string& tok, uint64_t* nth) {
  std::string name = tok;
  size_t at = tok.find('@');
  if (at != std::string::npos) {
    name = tok.substr(0, at);
    *nth = strtoull(tok.c_str() + at + 1, nullptr, 10);
  }
  if (name == "short") return NF_SHORT;
  if (name == "eof") return NF_EOF;
  if (name == "drop") return NF_DROP;
  if (name == "kill") return NF_KILL;
  if (name == "stall") return NF_STALL;
  return NF_NONE;
}

// What each site can actually execute — a spec naming an action a hook
// silently ignores would count "injected" faults that never happen, so
// it is a PARSE error instead. (Doorbell delay is legal: the ring wake
// honors it and the shm wake expresses it as a drop — the consumer's
// bounded poll timeout IS the delay there.)
bool action_supported(int site, int action) {
  switch (site) {
    case NF_READ:
      return action == NF_ERR || action == NF_SHORT || action == NF_EOF ||
             action == NF_DELAY;
    case NF_WRITE:  // no delay: write paths may hold session locks
      return action == NF_ERR || action == NF_SHORT || action == NF_DROP;
    case NF_CONNECT:
      return action == NF_ERR || action == NF_DELAY;
    case NF_DOORBELL:
      return action == NF_DROP || action == NF_DELAY;
    case NF_WORKER:
      return action == NF_KILL || action == NF_STALL ||
             action == NF_DELAY;
    case NF_ACCEPT:  // err breaks the accept burst; delay stalls the loop
      return action == NF_ERR || action == NF_DELAY;
    case NF_SHUTDOWN:  // err = forced drain-deadline expiry
      return action == NF_ERR || action == NF_DELAY;
  }
  return false;
}

// Parse one ';'-clause into `r` (or the table seed). False on error.
bool parse_clause(const std::string& clause, FaultTable* t) {
  if (clause.empty()) return true;
  if (clause.compare(0, 5, "seed=") == 0) {
    t->seed = strtoull(clause.c_str() + 5, nullptr, 10);
    return true;
  }
  // split on ':'
  std::string toks[8];
  int ntok = 0;
  size_t pos = 0;
  while (ntok < 8) {
    size_t c = clause.find(':', pos);
    toks[ntok++] = clause.substr(pos, c == std::string::npos
                                          ? std::string::npos
                                          : c - pos);
    if (c == std::string::npos) break;
    pos = c + 1;
  }
  if (ntok == 0 || t->nrules >= kMaxRules) return false;
  FaultRule r;
  r.site = site_by_name(toks[0]);
  if (r.site < 0) return false;
  bool have_selector = false;
  for (int i = 1; i < ntok; i++) {
    const std::string& tok = toks[i];
    if (tok.compare(0, 2, "p=") == 0) {
      double p = atof(tok.c_str() + 2);
      if (p < 0.0) p = 0.0;
      if (p > 1.0) p = 1.0;
      r.p_bits = (uint32_t)(p * 4294967295.0);
      have_selector = true;
    } else if (tok.compare(0, 4, "err=") == 0) {
      r.action = NF_ERR;
      r.err = errno_by_name(tok.c_str() + 4);
      if (r.err == 0) return false;
    } else if (tok.compare(0, 9, "delay_ms=") == 0) {
      r.delay_ms = atoi(tok.c_str() + 9);
      if (r.action == NF_NONE) r.action = NF_DELAY;
    } else if (tok.compare(0, 3, "ms=") == 0) {
      r.delay_ms = atoi(tok.c_str() + 3);
    } else if (tok.compare(0, 4, "nth=") == 0) {
      r.nth = strtoull(tok.c_str() + 4, nullptr, 10);
      have_selector = true;
    } else if (tok.compare(0, 6, "every=") == 0) {
      r.every = strtoull(tok.c_str() + 6, nullptr, 10);
      have_selector = true;
    } else {
      uint64_t nth = 0;
      int act = action_token(tok, &nth);
      if (act == NF_NONE) return false;
      r.action = act;
      if (nth != 0) {
        r.nth = nth;
        have_selector = true;
      }
    }
  }
  if (r.action == NF_NONE || !action_supported(r.site, r.action)) {
    return false;
  }
  // stall with no ms= defaults to a visible-but-bounded pause
  if ((r.action == NF_STALL || r.action == NF_DELAY) && r.delay_ms <= 0) {
    r.delay_ms = 100;
  }
  r.always = !have_selector;
  t->rules[t->nrules++] = r;
  return true;
}

}  // namespace

void nat_fault_delay_ms(int ms) {
  if (ms > 0) std::this_thread::sleep_for(std::chrono::milliseconds(ms));
}

NatFaultAct nat_fault_hit(int site) {
  FaultTable* tp = g_active_table.load(std::memory_order_acquire);
  if (tp == nullptr) return NatFaultAct{};
  FaultTable& t = *tp;
  uint64_t op = t.ops[site].fetch_add(1, std::memory_order_relaxed) + 1;
  for (int i = 0; i < t.nrules; i++) {
    const FaultRule& r = t.rules[i];
    if (r.site != site) continue;
    bool fire;
    if (r.nth != 0) {
      fire = (op == r.nth);
    } else if (r.every != 0) {
      fire = (op % r.every == 0);
    } else if (r.p_bits != 0) {
      // splitmix64: the per-op decision — a pure function of (seed,
      // site, rule index, op), which is the determinism contract
      uint64_t h = nat_mix64(t.seed ^ ((uint64_t)site << 40) ^
                             ((uint64_t)i << 48) ^ op);
      fire = (uint32_t)h < r.p_bits;
    } else {
      fire = r.always;
    }
    if (!fire) continue;
    g_injected.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_FAULTS_INJECTED, 1);
    NatFaultAct act;
    act.action = r.action;
    act.err = r.err;
    act.delay_ms = r.delay_ms;
    return act;
  }
  return NatFaultAct{};
}

extern "C" {

// Install (or clear, with NULL/"") the fault table. Per-site op counters
// reset, so `nth=` selectors count from the configure call. Returns 0,
// or -1 on a parse error (the previous table stays installed).
int nat_fault_configure(const char* spec) {
  if (spec == nullptr || spec[0] == '\0') {
    // disarm only — the (leaked) table keeps its counters, so an
    // in-flight hook finishes against a consistent rules+ops snapshot
    g_nat_fault_on.store(0, std::memory_order_release);
    return 0;
  }
  FaultTable* t = new FaultTable();  // predecessor leaked: see above
  std::string s(spec);
  size_t pos = 0;
  while (pos <= s.size()) {
    size_t semi = s.find(';', pos);
    std::string clause = s.substr(
        pos, semi == std::string::npos ? std::string::npos : semi - pos);
    if (!parse_clause(clause, t)) {
      delete t;
      return -1;
    }
    if (semi == std::string::npos) break;
    pos = semi + 1;
  }
  // One release store publishes rules AND zeroed op counters together:
  // a hook reads either the old table's (rules, ops) pair or the new
  // one — nth= selectors count from this configure by construction.
  g_active_table.store(t, std::memory_order_release);
  g_nat_fault_on.store(t->nrules > 0 ? 1u : 0u, std::memory_order_release);
  return 0;
}

int nat_fault_enabled(void) {
  return g_nat_fault_on.load(std::memory_order_acquire) != 0 ? 1 : 0;
}

uint64_t nat_fault_injected(void) {
  return g_injected.load(std::memory_order_relaxed);
}

}  // extern "C"

// Env arming: workers and test processes inherit NAT_FAULT and arm the
// table the moment the library loads — before any runtime thread exists.
__attribute__((constructor)) static void nat_fault_env_init() {
  const char* s = getenv("NAT_FAULT");
  if (s != nullptr && s[0] != '\0') nat_fault_configure(s);
}

}  // namespace brpc_tpu
