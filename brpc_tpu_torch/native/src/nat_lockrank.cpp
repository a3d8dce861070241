// Runtime lock-rank validator (see nat_lockrank.h). Compiled into the
// library only under -DNAT_LOCKRANK=1 (`make -C native lockrank`); the
// production build gets an empty TU.
#include "nat_lockrank.h"

#if defined(NAT_LOCKRANK)

#include <cstdio>
#include <cstdlib>

namespace brpc_tpu {
namespace lockrank {

namespace {
constexpr int kMaxHeld = 32;
struct Held {
  int ranks[kMaxHeld];
  int n = 0;
};
thread_local Held t_held;

[[noreturn]] void violation(const char* what, int rank) {
  fprintf(stderr, "nat_lockrank: %s (rank %d; held:", what, rank);
  for (int i = 0; i < t_held.n; i++) {
    fprintf(stderr, " %d", t_held.ranks[i]);
  }
  fprintf(stderr, ")\n");
  fflush(stderr);
  abort();
}
}  // namespace

void note_acquire(int rank) {
  if (t_held.n > 0 && t_held.ranks[t_held.n - 1] >= rank) {
    violation("blocking acquisition does not increase the held rank",
              rank);
  }
  if (t_held.n >= kMaxHeld) violation("held-rank stack overflow", rank);
  t_held.ranks[t_held.n++] = rank;
}

void note_acquired(int rank) {
  if (t_held.n >= kMaxHeld) violation("held-rank stack overflow", rank);
  t_held.ranks[t_held.n++] = rank;
}

void note_release(int rank) {
  // unlock order is usually LIFO but unique_lock::unlock can release
  // out of order: remove the DEEPEST matching entry
  for (int i = t_held.n - 1; i >= 0; i--) {
    if (t_held.ranks[i] == rank) {
      for (int j = i; j < t_held.n - 1; j++) {
        t_held.ranks[j] = t_held.ranks[j + 1];
      }
      t_held.n--;
      return;
    }
  }
  violation("release of a rank not held", rank);
}

void assert_none_held(const char* where) {
  if (t_held.n != 0) {
    fprintf(stderr, "nat_lockrank: %s\n", where);
    violation("NatMutex held across a fiber switch", t_held.ranks[0]);
  }
}

}  // namespace lockrank
}  // namespace brpc_tpu

#endif  // NAT_LOCKRANK
