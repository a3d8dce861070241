// nat::atomic — the atomic-type seam between the production build and
// the dsched deterministic interleaving checker (native/model/).
//
// The lock-free primitives that the model explores (wsq.h's Chase-Lev
// deque, nat_desc_ring.h's Vyukov descriptor ring + blob arena) declare
// their atomics as nat::atomic<T> instead of std::atomic<T>:
//
//   * production / sanitizer / lockrank builds: nat::atomic IS
//     std::atomic (alias template, zero cost, identical layout);
//   * the model build (-DNAT_MODEL=1): nat::atomic is dsched::atomic,
//     whose every load/store/RMW is a schedule point of the cooperative
//     virtual-thread scheduler, with store-history + vector-clock
//     modeling so relaxed loads can return stale values the real
//     hardware is allowed to produce.
//
// The same source files compile unmodified under both.
#pragma once

#if defined(NAT_MODEL)

#include "dsched_atomic.h"  // model build adds -Imodel; defines nat::*

#else

#include <atomic>

namespace nat {

template <typename T>
using atomic = std::atomic<T>;

inline void atomic_thread_fence(std::memory_order o) {
  std::atomic_thread_fence(o);
}

}  // namespace nat

#endif
