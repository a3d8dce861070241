// nat_res — per-subsystem resource accounting for the native runtime
// (the memory observatory, ISSUE 14).
//
// The reference ships memory observability as product: tcmalloc-backed
// /heap + /growth builtin services and per-resource bvars
// (bvar::PassiveStatus over MallocExtension, SURVEY §2.11). This runtime
// owns its allocators — iobuf block pool + TLS caches, socket slabs,
// WriteReq node pools, fiber stack pool, shm blob arenas, dump/prof cell
// pools — so tcmalloc sees nothing and tracemalloc (builtin/profilers.py)
// sees even less. nat_res is the native twin:
//
//  * an ALWAYS-ON ledger: every real allocation seam (a pool MISS that
//    reaches new/malloc/mmap — pool hits stay untouched) records into a
//    per-thread NatResCell (the nat_stats single-writer relaxed-store
//    discipline) under its subsystem id; live bytes/objects are the
//    combined alloc-free sums, and a per-subsystem global pair feeds the
//    high-water mark. Cost when idle: zero — the seams only run on pool
//    growth/shrink, never on the per-call hot path.
//
//  * a sampled ALLOCATION-SITE profiler (armed via nat_res_prof_start,
//    or lazily by the first /heap/native request — the tracemalloc
//    ensure-on-first-profile discipline): armed seams capture a
//    frame-pointer stack (nat_prof's unwind) into per-tid seqlock rings
//    (nat_prof's cell/ring machinery), a collector folds alloc/free
//    events — globally ordered by a ticket so a cross-thread free lands
//    after its alloc — into a live-bytes-by-site map. /heap/native
//    renders it as collapsed stacks weighted by live bytes; /growth/
//    native diffs live-bytes-by-site against a baseline snapshot.
//
// The natcheck `resacct` lint rule closes the adoption loop: a raw
// new/malloc/mmap inside a TU that uses these macros must sit next to a
// NAT_RES_* call or carry a `// natcheck:allow(resacct): why` escape.
//
// Record paths are LOCK-FREE (atomics + ring publish + raw syscalls):
// several seams run under registry locks (sock_create allocates while
// holding g_sock_alloc_mu), so taking any mutex here would be a
// lockorder violation.
#pragma once

#include <stddef.h>
#include <stdint.h>

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// subsystem ids — one row per native allocator seam; names exported via
// nat_res_name (the nat_mem_*{subsystem=} label values, drift-tested)
// ---------------------------------------------------------------------------

enum NatResSubsys : int {
  NR_IOBUF_BLOCK = 0,  // iobuf.cpp: 8KB IOBlocks (TLS caches + central
                       // batch pool; a block parked in a cache is LIVE)
  NR_IOBUF_REFS,       // iobuf.cpp: spilled BlockRef arrays (>6 refs)
  NR_SOCK_SLAB,        // nat_socket.cpp: NatSocket slabs + objects
                       // (ResourcePool discipline: never freed — live
                       // tracks the registry high-water mark)
  NR_SOCK_WREQ,        // nat_socket.cpp: WriteReq nodes (wstack pools)
  NR_SRV_PYREQ,        // PyRequest objects (py-lane handoff, shm lane)
  NR_SCHED_STACK,      // scheduler.cpp: fiber stacks (mmap, incl guard
                       // page) + Fiber/Worker objects
  NR_SHM_SEG,          // nat_shm_lane.cpp: shm segment mmaps (rings +
                       // blob arenas, parent and worker mappings)
  NR_SHM_SPAN,         // nat_shm_lane.cpp: blob-arena spans pinned by
                       // live descriptor-lane requests / tensor-fabric
                       // leases (bytes = leased payload; freed at
                       // shm_req_span_release)
  NR_DUMP_SPILL,       // nat_dump.cpp: capture-ring spill buffers
  NR_PROF_CELLS,       // fixed BSS sample pools: nat_prof/mu-prof/res
                       // rings + span ring (NAT_RES_STATIC at .so init)
  NR_CLUSTER,          // nat_cluster.cpp: clusters, backends, their
                       // lazily-dialed NatChannels
  NR_STATS_CELL,       // nat_stats.cpp / nat_res.cpp: per-thread stat +
                       // resource cells (never freed, bvar discipline)
  NR_SELFTEST,         // nat_res_selftest's churn lane (tests/smokes
                       // get a deterministic subsystem no runtime
                       // thread touches — the mu.selftest discipline)
  NR_SUBSYS_COUNT,
};

// One snapshot row (ctypes mirror in brpc_tpu/native, layout in the ABI
// manifest): the per-resource-bvar surface + /status reconciliation.
struct NatResRow {
  uint64_t live_bytes;       // allocated minus freed, combined cells
  uint64_t live_objects;     // allocs minus frees
  uint64_t cum_allocs;       // allocation events since load
  uint64_t cum_frees;        // free events since load
  uint64_t cum_alloc_bytes;  // bytes ever allocated
  uint64_t hwm_bytes;        // high-water live bytes (global pair)
  char name[16];
};

// ---------------------------------------------------------------------------
// record API — the seams call these through the NAT_RES_* macros so the
// resacct lint can pair every raw allocation with its accounting line.
// Lock-free; safe under any lock and on any thread.
// ---------------------------------------------------------------------------

void nat_res_alloc(int sub, size_t bytes, void* ptr);
void nat_res_free(int sub, size_t bytes, void* ptr);
// Fixed pools (BSS sample rings, static tables): recorded once at init
// as a live allocation that is never freed — they are resident pages
// the RSS reconciliation must attribute.
void nat_res_static(int sub, size_t bytes);

// One object allocated/freed at a real allocator seam. `p` keys the
// sampled site profiler's address map (pass the object pointer; mmap
// seams pass the mapping base).
#define NAT_RES_ALLOC(sub, bytes, p) \
  ::brpc_tpu::nat_res_alloc((sub), (bytes), (void*)(p))
#define NAT_RES_FREE(sub, bytes, p) \
  ::brpc_tpu::nat_res_free((sub), (bytes), (void*)(p))
#define NAT_RES_STATIC(sub, bytes) ::brpc_tpu::nat_res_static((sub), (bytes))

}  // namespace brpc_tpu
