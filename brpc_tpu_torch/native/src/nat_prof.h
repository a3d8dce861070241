// nat_prof — in-process sampling profiler for the native runtime.
//
// The /hotspots/cpu role (SURVEY §5: hotspots_service.h + gperftools'
// ProfileHandler) done TPU-serving-shaped: a SIGPROF interval timer
// drives CPU-time sampling of whichever threads are actually burning
// cycles; the signal handler walks the frame-pointer chain (the build
// keeps -fno-omit-frame-pointer for exactly this) into a lock-free
// per-thread sample ring, and collection/symbolization (dladdr +
// __cxa_demangle) happens entirely OUTSIDE signal context. Reports come
// out two ways: a flat self-sample symbol table (the PROFILE_r*.md
// shape) and collapsed stacks (flamegraph.pl / speedscope ingestible).
//
// Signal-handler discipline: the handler is restricted to
// async-signal-safe operations — raw syscalls (gettid,
// process_vm_readv to probe frame words without faulting), lock-free
// atomics and memcpy into preallocated rings. No allocation, no locks,
// no TLS with lazy init. tools/natcheck's `sigsafe` lint rule enforces
// this over every *_sighandler function in native/src.
//
// Exports (nat_api.h): nat_prof_start(hz) / nat_prof_stop() /
// nat_prof_running() / nat_prof_samples() / nat_prof_report(mode,...) /
// nat_prof_reset().
#pragma once

#include <stdint.h>

#include <atomic>
#include <map>
#include <string>

#include "nat_stats.h"  // nat_mix64 (cell hashing)

namespace brpc_tpu {

inline constexpr int kProfMaxFrames = 24;   // pcs kept per sample
inline constexpr uint32_t kProfRing = 256;  // samples buffered per thread
inline constexpr int kProfCells = 64;       // concurrent sampled threads

// Claim (or find) the cell for `tid`: open addressing over a fixed
// pool, CAS on the tid word. No allocation, no locks — shared by the
// SIGPROF ring, the mutex-contention ring and the nat_res allocation
// ring (the seqlock publish/drain pairs stay per-ring: one writer runs
// in signal context under the sigsafe lint, payloads and drop
// accounting differ; a protocol change there must be applied to ALL
// rings and the span ring in nat_stats.cpp).
template <typename Cell, size_t N>
Cell* claim_cell(Cell (&pool)[N], int32_t tid) {
  uint32_t h = (uint32_t)(nat_mix64((uint64_t)tid) % N);
  for (size_t probe = 0; probe < N; probe++) {
    Cell* c = &pool[(h + probe) % N];
    int32_t cur = c->tid.load(std::memory_order_acquire);
    if (cur == tid) return c;
    if (cur == 0) {
      int32_t expect = 0;
      if (c->tid.compare_exchange_strong(expect, tid,
                                         std::memory_order_acq_rel)) {
        return c;
      }
      if (expect == tid) return c;  // lost to ourselves? (impossible) —
                                    // lost to another tid: keep probing
    }
  }
  return nullptr;  // pool full: drop the sample
}

// Frame-pointer walk from the CALLER's frame (normal code, not signal
// context; probe-read bounded monotone — defined in nat_prof.cpp,
// shared with nat_res's allocation-site sampler).
int nat_fp_backtrace(uintptr_t* out, int max);

// pc -> demangled symbol (dladdr + __cxa_demangle, cached) — the one
// symbolizer every native profile report goes through.
std::string nat_prof_symbolize_pc(uintptr_t pc,
                                  std::map<uintptr_t, std::string>* cache);

}  // namespace brpc_tpu
