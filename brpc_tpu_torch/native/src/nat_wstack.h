// WStack — the wait-free MPSC socket-write stack, the native counterpart
// of brpc Socket's write discipline (socket.h:293-333 + socket.cpp
// StartWrite/IsWriteComplete):
//
//   * N writers enqueue with ONE atomic exchange each — no lock, no CAS
//     loop, no contention window beyond the exchange itself;
//   * the writer whose exchange observed an empty head BECOMES the single
//     drainer; the role is held continuously (inline writev attempt,
//     KeepWrite fiber, io_uring send completion, retry list) until
//     grab_more's CAS returns the head to nullptr;
//   * the stack is newest-first; the drainer lazily reverses freshly
//     pushed segments into FIFO order, spinning (with a yield) across the
//     1-2 instruction window where a pusher has exchanged itself onto the
//     head but not yet linked its `wnext`.
//
// Invariant the protocol lanes rely on: head == nullptr  <=>  no queued
// bytes AND no active drainer — the "everything flushed" predicate the
// ordered-reply (HTTP/redis) close paths check (NatSocket::write_idle).
//
// Like wsq.h and nat_desc_ring.h this header compiles unmodified under
// -DNAT_MODEL (nat::atomic resolves to dsched::atomic): the exactly-once
// drain under concurrent enqueue / drainer-exit races is explored by the
// `wstack` scenario in native/model/nat_model_main.cpp.
#pragma once

#include "nat_atomic.h"

#if defined(NAT_MODEL)
#define NAT_WSTACK_SPIN() dsched::yield()
#else
#include <sched.h>
#define NAT_WSTACK_SPIN() sched_yield()
#endif

namespace brpc_tpu {

// Req must carry an intrusive `nat::atomic<Req*> wnext` link.
template <typename Req>
class WStack {
 public:
  // Sentinel for "exchanged onto the head, link not yet stored" — the
  // reference's UNCONNECTED marker. Never dereferenced.
  static Req* unlinked() { return reinterpret_cast<Req*>(1); }

  // head == nullptr <=> stack empty AND no drainer active (see above).
  bool empty() const {
    return head_.load(std::memory_order_acquire) == nullptr;
  }

  // Wait-free enqueue. Returns true when the CALLER became the drainer:
  // r is then the head of a one-node FIFO chain (r->wnext == nullptr)
  // and the caller must drive the drain until grab_more releases the
  // role. Returns false when an active drainer will pick r up.
  bool push(Req* r) {
    r->wnext.store(unlinked(), std::memory_order_relaxed);
    // release: the drainer's acquire walk must see r's payload
    Req* prev = head_.exchange(r, std::memory_order_acq_rel);
    if (prev != nullptr) {
      r->wnext.store(prev, std::memory_order_release);
      return false;
    }
    r->wnext.store(nullptr, std::memory_order_release);
    return true;
  }

  // Drainer only. `last` is the final node of the drainer's current FIFO
  // chain — by construction the exact node the stack head pointed at
  // when the chain was formed (its wnext is nullptr). Attempts to CAS
  // head last -> nullptr:
  //   * success: the stack is empty, the role is RELEASED; returns
  //     nullptr (the caller now owns `last` outright and frees it);
  //   * failure: writers pushed above `last`; the fresh segment is
  //     reversed into FIFO order and linked behind `last`
  //     (last->wnext = oldest new node); returns that node — the drain
  //     continues, role retained.
  // No ABA hazard: only the drainer removes from the stack, and `last`
  // stays allocated until this call decides — a recycled node address
  // can reappear at the head only AFTER the role was released.
  Req* grab_more(Req* last) {
    Req* expected = last;
    if (head_.compare_exchange_strong(expected, nullptr,
                                      std::memory_order_acq_rel,
                                      std::memory_order_acquire)) {
      return nullptr;
    }
    // expected = current head (newest). Reverse newest..->..last into
    // FIFO links; a pusher mid-publication leaves wnext == unlinked()
    // for 1-2 instructions — yield across it (the reference spins the
    // same window, socket.cpp KeepWrite).
    Req* p = expected;
    Req* newer = nullptr;  // becomes p's FIFO successor
    while (p != last) {
      Req* n = p->wnext.load(std::memory_order_acquire);
      while (n == unlinked()) {
        NAT_WSTACK_SPIN();
        n = p->wnext.load(std::memory_order_acquire);
      }
      p->wnext.store(newer, std::memory_order_relaxed);
      newer = p;
      p = n;
    }
    last->wnext.store(newer, std::memory_order_relaxed);
    return newer;
  }

 private:
  nat::atomic<Req*> head_{nullptr};
};

}  // namespace brpc_tpu
