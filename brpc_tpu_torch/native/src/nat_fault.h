// nat_fault — seeded, deterministic fault injection for the native
// runtime (the "natfault" table).
//
// The failure paths PR 1-4 grew (retry-over-reconnect, backup requests,
// health-check revival, shm robust-fence recovery, KeepWrite requeue)
// had never executed under an injected fault. This header is the gate:
// every hook site in the runtime goes through NAT_FAULT_POINT, which
// costs ONE predictable branch (a relaxed load of g_nat_fault_on,
// __builtin_expect'd false) when no fault spec is installed — the
// tools/natcheck `fault-gate` lint rule enforces that no site calls
// nat_fault_hit() directly.
//
// Spec grammar (NAT_FAULT env var, read once at library load, or the
// nat_fault_configure export at any time; clauses ';'-separated, tokens
// ':'-separated):
//
//   seed=42                         xorshift seed for p= decisions
//   read:p=0.01:err=ECONNRESET      1% of reads fail with ECONNRESET
//   read:short:p=0.05               5% of reads truncated to 1 byte
//   write:short                     every write truncated to 1 byte
//   write:drop@1                    the 1st write vanishes (bytes lost)
//   connect:delay_ms=200:p=0.5      half the dials stall 200ms first
//   connect:err=ECONNREFUSED        every dial refused
//   doorbell:drop:p=0.1             10% of shm/ring wakes are lost
//   worker:kill@7                   SIGKILL self on the 7th shm take
//   worker:stall@3:ms=500           stall 500ms on the 3rd shm take
//
// Selectors: p=F (seeded hash), nth=N / action@N (exactly op N),
// every=N (every Nth op); no selector = every op. Determinism: the
// decision for op k of a site is a pure function of (seed, site, rule
// index, k) — the same seed over the same per-site op sequence replays
// the same fault schedule.
//
// Per-site action support is VALIDATED at parse time (an accepted spec
// never counts faults a hook would ignore):
//   read      err | short | eof | delay
//   write     err | short | drop        (no delay: session locks)
//   connect   err | delay
//   doorbell  drop | delay  (shm wakes express delay as a drop — the
//                            consumer's bounded poll timeout IS the delay)
//   worker    kill | stall | delay
//   accept    err | delay   (err breaks this accept burst; delay stalls
//                            the dispatcher loop before accept4 — the
//                            accept-vs-teardown race window widener)
//   shutdown  err | delay   (quiesce drain loop: err = forced drain-
//                            deadline expiry NOW; delay stretches a
//                            drain poll round)
#pragma once

#include <stdint.h>

#include <atomic>

namespace brpc_tpu {

// hook sites (one op counter each; keep in sync with kFaultSiteNames)
enum NatFaultSite : int {
  NF_READ = 0,   // socket reads (epoll drain / fill / TLS feed)
  NF_WRITE,      // socket write batches (flush_chain)
  NF_CONNECT,    // client dials (dial_nonblocking)
  NF_DOORBELL,   // shm futex wakes + ring poller wake_fn
  NF_WORKER,     // shm worker request takes
  NF_ACCEPT,     // server accept4 (accept_loop)
  NF_SHUTDOWN,   // quiesce drain polls (nat_server_quiesce)
  NF_SITE_COUNT,
};

enum NatFaultAction : int {
  NF_NONE = 0,
  NF_ERR,    // fail the op with `err` in errno
  NF_SHORT,  // truncate the I/O to 1 byte
  NF_EOF,    // reads: pretend the peer closed
  NF_DROP,   // writes: bytes vanish; doorbells: wake lost
  NF_DELAY,  // sleep delay_ms first, then proceed normally
  NF_KILL,   // worker: raise(SIGKILL) — the shm crash-recovery drill
  NF_STALL,  // worker: sleep delay_ms mid-request
};

struct NatFaultAct {
  int action = NF_NONE;
  int err = 0;       // errno for NF_ERR
  int delay_ms = 0;  // NF_DELAY / NF_STALL
};

// The one-branch gate: nonzero while a fault table is installed.
extern std::atomic<uint32_t> g_nat_fault_on;

// Slow path: charge one op to `site` and return the matching action (if
// any). Never call directly — go through NAT_FAULT_POINT (enforced by
// the natcheck fault-gate lint rule).
NatFaultAct nat_fault_hit(int site);

// Bounded sleep used by the delay/stall actions (plain thread sleep: a
// fault that parks the carrying thread is exactly the perturbation the
// schedule is asking for).
void nat_fault_delay_ms(int ms);

// The ONLY sanctioned hook shape: disabled cost is one relaxed load +
// one predicted-not-taken branch; no call, no table walk.
#define NAT_FAULT_POINT(site)                                       \
  (__builtin_expect(::brpc_tpu::g_nat_fault_on.load(                \
                        std::memory_order_relaxed) != 0,            \
                    0)                                              \
       ? ::brpc_tpu::nat_fault_hit(site)                            \
       : ::brpc_tpu::NatFaultAct{})

}  // namespace brpc_tpu
