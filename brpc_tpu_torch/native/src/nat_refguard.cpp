// Runtime refcount-contract validator (see nat_refown.h). The ledger is
// compiled into the library only under -DNAT_REFGUARD=1 (`make -C native
// refguard`); production builds get the exported stubs and nothing else.
//
// Per tracked object (keyed by pointer — socket slabs are never freed,
// and heap objects revive their ledger entry on the next annotated
// acquire after malloc reuse): a generation, a dead bit, and a small
// per-tag balance table. Every NAT_REF_* macro feeds it:
//
//   op(+1)/op(-1)   tag balance moves; a release that would drive a tag
//                   negative is a release-after-final / wrong-tag pair
//   transfer        from_tag balance moves to to_tag (no total change);
//                   a transfer out of an empty tag is a violation
//   borrow          the object must not be invalidated (dead)
//   dead            every tag must balance to ZERO; the generation bumps
//                   and the object is invalid until re-acquired
//
// Violations abort with the failing tag pair and the object's full
// ledger printed — the refcount twin of nat_lockrank.cpp's report.
#include "nat_refown.h"

#include "nat_api.h"

#if defined(NAT_REFGUARD)

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <atomic>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace brpc_tpu {
namespace refguard {

namespace {

std::atomic<uint64_t> g_ops{0};

struct TagBal {
  const char* tag;
  int64_t balance;
};

struct ObjLedger {
  uint32_t gen = 0;
  bool dead = false;
  std::vector<TagBal> tags;

  int64_t* find(const char* tag, bool create) {
    for (TagBal& t : tags) {
      if (t.tag == tag || strcmp(t.tag, tag) == 0) return &t.balance;
    }
    if (!create) return nullptr;
    tags.push_back(TagBal{tag, 0});
    return &tags.back().balance;
  }
  bool all_zero() const {
    for (const TagBal& t : tags) {
      if (t.balance != 0) return false;
    }
    return true;
  }
};

// 64-way sharded by pointer hash: the ledger op is on every ref
// operation in the instrumented build, and one global lock would
// serialize the whole runtime. Only ONE shard lock is ever held at a
// time, and the hooks acquire no other lock, so any rank may hold it —
// rank 99, past the rank-96 innermost production lock.
constexpr int kShards = 64;
struct Shard {
  // natcheck:rank(refguard, 99)
  std::mutex refguard_mu;
  std::unordered_map<const void*, ObjLedger> objs;
};
Shard& shard_for(const void* obj) {
  // natcheck:leak(refguard_shards): the ledger must survive exit() —
  // detached runtime threads keep releasing references through static
  // destruction (the PR-1 class).
  static Shard* shards = new Shard[kShards];
  uintptr_t p = (uintptr_t)obj;
  return shards[(p >> 4) % kShards];
}

[[noreturn]] void violation(const void* obj, const ObjLedger* led,
                            const char* what, const char* tag_a,
                            const char* tag_b) {
  fprintf(stderr, "nat_refguard: %s obj=%p tag=%s%s%s (ledger:", what,
          obj, tag_a, tag_b != nullptr ? " vs " : "",
          tag_b != nullptr ? tag_b : "");
  if (led != nullptr) {
    for (const TagBal& t : led->tags) {
      fprintf(stderr, " %s=%lld", t.tag, (long long)t.balance);
    }
    if (led->dead) fprintf(stderr, " [dead gen=%u]", led->gen);
  }
  fprintf(stderr, ")\n");
  fflush(stderr);
  abort();
}

}  // namespace

void op(const void* obj, const char* tag, int delta) {
  g_ops.fetch_add(1, std::memory_order_relaxed);
  Shard& sh = shard_for(obj);
  std::lock_guard g(sh.refguard_mu);
  ObjLedger& led = sh.objs[obj];
  if (delta > 0 && led.dead) {
    // a fresh acquire revives a recycled slot / reused allocation
    led.dead = false;
    led.gen++;
    led.tags.clear();
  }
  int64_t* bal = led.find(tag, /*create=*/true);
  *bal += delta;
  if (*bal < 0) {
    violation(obj, &led, "release with no owning acquire "
              "(release-after-final or wrong tag)", tag, nullptr);
  }
  if (delta < 0 && led.all_zero() && !led.dead) {
    // balanced and alive: drop the entry so short-lived objects
    // (PyRequests, WriteReq nodes) don't grow the table forever
    sh.objs.erase(obj);
  }
}

void transfer(const void* obj, const char* from_tag, const char* to_tag) {
  g_ops.fetch_add(1, std::memory_order_relaxed);
  Shard& sh = shard_for(obj);
  std::lock_guard g(sh.refguard_mu);
  auto it = sh.objs.find(obj);
  if (it == sh.objs.end()) {
    violation(obj, nullptr, "transfer on an untracked object", from_tag,
              to_tag);
  }
  ObjLedger& led = it->second;
  int64_t* from = led.find(from_tag, /*create=*/false);
  if (from == nullptr || *from <= 0) {
    violation(obj, &led, "transfer from a tag with no held reference",
              from_tag, to_tag);
  }
  (*from)--;
  (*led.find(to_tag, /*create=*/true))++;
}

void borrow(const void* obj) {
  g_ops.fetch_add(1, std::memory_order_relaxed);
  Shard& sh = shard_for(obj);
  std::lock_guard g(sh.refguard_mu);
  auto it = sh.objs.find(obj);
  if (it != sh.objs.end() && it->second.dead) {
    violation(obj, &it->second, "borrow after invalidate", "(borrow)",
              nullptr);
  }
}

void dead(const void* obj) {
  g_ops.fetch_add(1, std::memory_order_relaxed);
  Shard& sh = shard_for(obj);
  std::lock_guard g(sh.refguard_mu);
  auto it = sh.objs.find(obj);
  if (it == sh.objs.end()) {
    // every tag already balanced to zero (the entry was dropped): mark
    // the identity dead so a late borrow still aborts
    ObjLedger& fresh = sh.objs[obj];
    fresh.dead = true;
    fresh.gen++;
    return;
  }
  ObjLedger& led = it->second;
  if (led.dead) {
    violation(obj, &led, "double destruction", "(dead)", nullptr);
  }
  if (!led.all_zero()) {
    violation(obj, &led, "destroyed with unbalanced tags", "(dead)",
              nullptr);
  }
  led.dead = true;
  led.gen++;
  led.tags.clear();
}

}  // namespace refguard

const void* nat_ref_adm_anchor() {
  static const int anchor = 0;
  return &anchor;
}

}  // namespace brpc_tpu

extern "C" {

int nat_refguard_enabled(void) { return 1; }

uint64_t nat_refguard_ops(void) {
  return brpc_tpu::refguard::g_ops.load(std::memory_order_relaxed);
}

int nat_refguard_selftest(int scenario) {
  struct Dummy {
    int refs = 1;
    void add_ref() { refs++; }
    void release() { refs--; }
  };
  static Dummy d;  // stable identity across calls
  if (scenario == 0) {
    // balanced round: the full grammar on one object
    NAT_REF_ACQUIRED(&d, selftest.a);
    NAT_REF_ACQUIRE(&d, selftest.b);
    NAT_REF_TRANSFER(&d, selftest.a, selftest.c);
    NAT_REF_BORROW(&d);
    NAT_REF_RELEASE(&d, selftest.b);
    NAT_REF_RELEASED(&d, selftest.c);
    NAT_REF_DEAD(&d);
    return 0;
  }
  if (scenario == 1) {
    // deliberate double release: the guard must abort with the tag pair
    NAT_REF_ACQUIRED(&d, selftest.dbl);
    NAT_REF_RELEASED(&d, selftest.dbl);
    // natcheck:allow(refown-double-release): the deliberate defect
    NAT_REF_RELEASED(&d, selftest.dbl);  // aborts here
    return -2;                           // unreachable under refguard
  }
  return -1;
}

}  // extern "C"

#else  // !NAT_REFGUARD: exported stubs so the ABI is build-invariant

namespace brpc_tpu {
const void* nat_ref_adm_anchor() {
  static const int anchor = 0;
  return &anchor;
}
}  // namespace brpc_tpu

extern "C" {
int nat_refguard_enabled(void) { return 0; }
uint64_t nat_refguard_ops(void) { return 0; }
int nat_refguard_selftest(int scenario) {
  return scenario == 0 ? 0 : -1;
}
}  // extern "C"

#endif  // NAT_REFGUARD
