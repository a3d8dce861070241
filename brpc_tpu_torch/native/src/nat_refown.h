// Declared ownership/refcount contracts — the repo's reference-counting
// discipline made machine-checkable, the refcount twin of nat_lockrank.h:
//
//   * statically by tools/natcheck/refown.py, which parses every
//     NAT_REF_* site across native/src, builds the acquire/release/
//     transfer graph per TAG (with transitive call closure and
//     lambda/fiber handoffs) and fails on unbalanced contracts: an
//     acquire whose tag has no reachable release, a release with no
//     owning acquire, an early-return arm that leaks a held tag, a
//     borrow used after a reachable release, and raw add_ref()/release()
//     calls outside this macro surface;
//   * at runtime under -DNAT_REFGUARD=1 (`make -C native refguard`,
//     driven by nat_smoke + the tools/check.sh --refguard pytest
//     matrix): every tracked object carries a generation + per-tag
//     balance ledger asserting balanced counts at destruction,
//     release-after-final, and borrow-after-invalidate — a violation
//     aborts with the failing tag pair printed.
//
// The grammar replaces the prose comments ("released by the sweep
// fiber", "held by the revival chain") that used to be the only record
// of who owns each reference. Every acquire names the TAG that will
// release it; a reader greps the tag to find the matching release, and
// the checker proves one exists.
//
//   NAT_REF_ACQUIRE(obj, tag)   take a counted reference on `obj`
//                               (expands to obj->add_ref()); the
//                               reference is owned by `tag` until a
//                               NAT_REF_RELEASE/TRANSFER of that tag
//   NAT_REF_RELEASE(obj, tag)   drop the `tag`-owned reference
//                               (expands to obj->release())
//   NAT_REF_ACQUIRED(obj, tag)  annotation-only acquire: the count
//                               change happened by other means (an
//                               init store, a CAS pin loop, a bespoke
//                               token bit) on the adjacent line
//   NAT_REF_RELEASED(obj, tag)  annotation-only release twin
//   NAT_REF_TRANSFER(obj, from_tag, to_tag)
//                               ownership moves between holders with no
//                               count change (admission token riding
//                               onto a shm InflightEntry, a creator ref
//                               becoming the TLS share ref)
//   NAT_REF_BORROW(obj)         marks a non-owning use of a reference
//                               somebody else holds; refguard asserts
//                               the object has not been invalidated
//   NAT_REF_DEAD(obj)           the object is being destroyed/recycled:
//                               refguard asserts every tag balances to
//                               zero and invalidates the generation
//
// In normal builds the annotations compile to NOTHING beyond the
// operation they wrap (ACQUIRE/RELEASE are exactly the add_ref/release
// call they replaced; the rest are (void)0) — the hot path is
// byte-identical to the pre-annotation code.
//
// Tags are dotted owner names, declared ONCE in the table below (an
// undeclared tag is a refown finding) — `<object>.<holder>` like the
// lock ranks' `<area>.<lock>` names.
#pragma once

#include <stdint.h>

// ---------------------------------------------------------------------------
// Tag table — the single source of truth refown.py checks usage against.
// One line per contract: who holds the reference and which release
// retires it.
// ---------------------------------------------------------------------------

#define NAT_REF_TAG(tag, doc)

// NatSocket (versioned_ref; slot recycles at refcount 0 — sock.registry
// is the creator reference every socket starts with):
NAT_REF_TAG(sock.registry, "sock_create's creator/registry reference; "
            "dropped by set_failed after sock_unregister")
NAT_REF_TAG(sock.borrow, "sock_address / sock_try_pin borrowed pin: the "
            "caller releases when done with the pointer")
NAT_REF_TAG(sock.keepwrite, "KeepWrite fiber parked on EPOLLOUT owns the "
            "socket (and the drain role) until the chain flushes")
NAT_REF_TAG(sock.ringsend, "an in-flight io_uring fixed-buffer send; its "
            "completion (the next drain-role holder) releases")
NAT_REF_TAG(sock.ringretry, "a g_ring_retry entry parked for a free "
            "SQE/send buffer; the retry pass releases")
NAT_REF_TAG(sock.sweep, "set_failed's detached fail-own sweep fiber "
            "(h2c/httpc stragglers of a detached socket)")

// NatChannel (plain ref count; deleted at 0):
NAT_REF_TAG(chan.opener, "nat_channel_open's creating reference; "
            "nat_channel_close releases")
NAT_REF_TAG(chan.sock, "the owning socket's channel reference; "
            "NatSocket::release drops it at slot recycle")
NAT_REF_TAG(chan.revival, "the health-check revival chain (timer + dial "
            "fiber) armed by set_failed")
NAT_REF_TAG(chan.timer, "a pending call-timeout timer entry")
NAT_REF_TAG(chan.backup, "a pending backup-request timer entry")

// NatServer (plain ref count; deleted at 0):
NAT_REF_TAG(srv.registry, "the global registration reference; "
            "nat_rpc_server_stop releases")
NAT_REF_TAG(srv.sock, "an accepted connection's server reference; "
            "NatSocket::release drops it at slot recycle")
NAT_REF_TAG(srv.accept, "the dispatcher's accept-burst pin, taken under "
            "listen_mu so a racing stop cannot free the server")
NAT_REF_TAG(srv.taker, "a py-lane taker inside take_py/take_py_batch")
NAT_REF_TAG(srv.quiesce, "nat_server_quiesce's drain-scan pin")

// IOBuf blocks (IOBlock::ref; recycles to the block pools at 0):
NAT_REF_TAG(iob.creator, "IOBlock::create's initial reference, owned by "
            "the creating scope until released or transferred")
NAT_REF_TAG(iob.share, "the TLS share block (share_tls_block "
            "discipline); the thread cache releases or replaces it")
NAT_REF_TAG(iob.ref, "one BlockRef slot in some IOBuf holds the block; "
            "pop/clear releases (moves between IOBufs keep the tag)")

// WriteReq pool nodes (not refcounted — a pooled-object token):
NAT_REF_TAG(wreq.node, "a live write-stack node between wreq_alloc and "
            "the drainer's wreq_free")

// Overload admission tokens (PyRequest::admitted bit; one global
// anchor object tracks the in-flight total):
NAT_REF_TAG(adm.pyreq, "an admitted request's in-flight token while the "
            "PyRequest owns it (~PyRequest / overload_expire release)")
NAT_REF_TAG(adm.inflight, "the token after shm_lane_offer transferred it "
            "onto the InflightEntry; the erase sites release")

// shm blob-arena spans (descriptor-lane PyRequests read in place):
NAT_REF_TAG(shm.span, "an arena span pinned by a descriptor-lane "
            "PyRequest's field views; nat_req_free releases")
NAT_REF_TAG(shm.lease, "a tensor-fabric span leased to the receiver by "
            "nat_shm_fabric_take (held past the drain loop, released "
            "out of order); shm_req_span_release retires it")

// refguard selftest tags (nat_refguard_selftest's dummy object — the
// balanced round and the deliberately-broken golden scenario):
NAT_REF_TAG(selftest.a, "selftest: acquired then transferred to c")
NAT_REF_TAG(selftest.b, "selftest: plain acquire/release pair")
NAT_REF_TAG(selftest.c, "selftest: receives a's transfer, then released")
NAT_REF_TAG(selftest.dbl, "selftest: the deliberate double release")

// Native fan-out cluster (nat_cluster.cpp / nat_lb.{h,cpp}):
NAT_REF_TAG(clus.opener, "nat_cluster_create's creating reference; "
            "nat_cluster_close releases")
NAT_REF_TAG(clus.verb, "one in-flight cluster verb/control op pins the "
            "cluster (gate + version machinery) until it returns")
NAT_REF_TAG(clus.member, "the cluster member map's backend reference; "
            "a naming removal (or close) releases")
NAT_REF_TAG(clus.ver, "one ServerListVer entry holds the backend; "
            "released when the version retires after the gate quiesce")
NAT_REF_TAG(clus.call, "an in-flight sub-call/selective attempt pins its "
            "backend; the completion/accounting path releases")

// fuzz harness fake connections (nat_fuzz_entry.cpp's FuzzConn):
NAT_REF_TAG(sock.fuzz, "FuzzConn's heap socket (fd=/dev/null, never "
            "registered); the FuzzConn dtor releases after each exec")
NAT_REF_TAG(srv.fuzz, "FuzzConn's handler-less server; the FuzzConn "
            "dtor releases after the socket")

// bench harness connections (AsyncBenchConn / CliLaneConn):
NAT_REF_TAG(bench.owner, "the bench harness + sender fiber's own "
            "reference, dropped when the bench round retires the conn")
NAT_REF_TAG(bench.call, "one in-flight async call; the completion "
            "callback releases")

#undef NAT_REF_TAG

// ---------------------------------------------------------------------------
// refguard hooks (nat_refguard.cpp) — ledger ops under -DNAT_REFGUARD,
// exported stubs otherwise so the ABI surface is build-invariant.
// ---------------------------------------------------------------------------

namespace brpc_tpu {
namespace refguard {
// delta = +1 acquire / -1 release; annotation-only ops use the same
// entry points. A release driving a tag below zero, a transfer from a
// tag with no balance, a borrow of an invalidated object, or a dead
// object with unbalanced tags aborts with the ledger printed.
void op(const void* obj, const char* tag, int delta);
void transfer(const void* obj, const char* from_tag, const char* to_tag);
void borrow(const void* obj);
void dead(const void* obj);
}  // namespace refguard

// Anchor object for resources that migrate between owners (admission
// tokens): the ledger needs ONE stable identity across the transfer.
const void* nat_ref_adm_anchor();
}  // namespace brpc_tpu

#if defined(NAT_REFGUARD)

#define NAT_REF_ACQUIRE(obj, tag)                          \
  do {                                                     \
    ::brpc_tpu::refguard::op((obj), #tag, +1);             \
    (obj)->add_ref();                                      \
  } while (0)
#define NAT_REF_RELEASE(obj, tag)                          \
  do {                                                     \
    ::brpc_tpu::refguard::op((obj), #tag, -1);             \
    (obj)->release();                                      \
  } while (0)
#define NAT_REF_ACQUIRED(obj, tag) \
  ::brpc_tpu::refguard::op((obj), #tag, +1)
#define NAT_REF_RELEASED(obj, tag) \
  ::brpc_tpu::refguard::op((obj), #tag, -1)
#define NAT_REF_TRANSFER(obj, from_tag, to_tag) \
  ::brpc_tpu::refguard::transfer((obj), #from_tag, #to_tag)
#define NAT_REF_BORROW(obj) ::brpc_tpu::refguard::borrow((obj))
#define NAT_REF_DEAD(obj) ::brpc_tpu::refguard::dead((obj))

#else  // normal builds: the op the macro wraps, nothing else

#define NAT_REF_ACQUIRE(obj, tag) ((obj)->add_ref())
#define NAT_REF_RELEASE(obj, tag) ((obj)->release())
#define NAT_REF_ACQUIRED(obj, tag) ((void)0)
#define NAT_REF_RELEASED(obj, tag) ((void)0)
#define NAT_REF_TRANSFER(obj, from_tag, to_tag) ((void)0)
#define NAT_REF_BORROW(obj) ((void)sizeof(obj))
#define NAT_REF_DEAD(obj) ((void)0)

#endif  // NAT_REFGUARD

// The extern "C" exports (nat_refguard_enabled / nat_refguard_ops /
// nat_refguard_selftest) are declared in nat_api.h like every other
// FFI symbol — single source of truth for the ABI manifest.
