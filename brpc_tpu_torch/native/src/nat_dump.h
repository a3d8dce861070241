// nat_dump — the native traffic flight recorder (rpc_dump's C++ twin).
//
// The reference treats capture/replay as product (SURVEY §2.11): rpc_dump
// samples live requests into rotated recordio files and rpc_replay
// re-fires them. This is that capture half for the native runtime: a
// sampled, always-on tap at the protocol seams (tpu_std cut loop, native
// HTTP usercode, gRPC/h2 dispatch, the redis store, and kind-8 shm
// descriptors) — seeded deterministic decimation (the PR-9 contention-
// sampler discipline), lock-free per-thread SPSC capture rings, and a
// background writer draining them into butil/recordio.py-compatible
// files rotated in generations like the rpcz SpanDB. Every sample
// carries the wire's (trace_id, span_id), so a capture file
// cross-references /rpcz spans and nat_prof profiles from the same
// window. The replay half lives in nat_replay.cpp.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "iobuf.h"

namespace brpc_tpu {

// ring geometry: 64 threads x 256 samples (a ring must absorb a full
// writer tick of burst traffic at 1-in-1 sampling — the rings are
// lazily-mapped BSS, so untouched slots cost nothing); payloads up to
// kDumpInline live in the slot, bigger ones spill to a malloc owned by
// the slot until the writer consumes it (the tap runs on the DECIMATED
// path, so a rare malloc is off the per-request hot path).
inline constexpr int kDumpCells = 64;
inline constexpr uint32_t kDumpRing = 256;
inline constexpr size_t kDumpInline = 1024;
// name capacities: a name that does not fit is NOT truncated — a
// truncated method replays the wrong endpoint, so the sample is
// skipped whole and counted oversize, same policy as payloads. 256
// covers real gRPC :paths and HTTP URIs with headroom.
inline constexpr int kDumpSvcMax = 64;
inline constexpr int kDumpMethodMax = 256;
inline constexpr int kDumpVerbMax = 8;

// status snapshot (ctypes mirror in brpc_tpu/native; layout in the ABI
// manifest). Counts are SINCE THE CURRENT start (the monotonic
// cross-run totals ride the nat_dump_* NS_ counters in /vars).
struct NatDumpStatusRec {
  uint64_t samples;         // records captured into the rings
  uint64_t written;         // records persisted to recordio files
  uint64_t bytes;           // file bytes written (headers + meta + payload)
  uint64_t drops;           // ring-full drops (writer behind)
  uint64_t oversize;        // payloads past max_payload, skipped whole
  uint64_t rotations;       // file generation rollovers
  uint64_t max_file_bytes;  // rotation threshold
  uint64_t max_payload;     // per-sample payload cap
  uint64_t seed;            // decimation seed
  uint32_t every;           // 1-in-N sampling stride
  int32_t running;          // 1 while armed
  int32_t generations;      // files kept (older unlinked)
  char dir[192];            // capture directory
};

// replay result (ctypes mirror; filled by nat_replay_run).
struct NatReplayResult {
  uint64_t loaded;   // records parsed from the capture files
  uint64_t sent;     // calls fired (loaded-replayable x times)
  uint64_t ok;       // completed with success
  uint64_t failed;   // completed with an error
  uint64_t skipped;  // records with no replayable client lane
  double seconds;    // wall time of the fire phase
  double qps;        // (ok + failed) / seconds
  double p50_us;     // latency quantiles over completed calls
  double p99_us;
};

// armed gate — one relaxed load on every tap site when off.
extern std::atomic<uint32_t> g_nat_dump_on;

inline bool nat_dump_enabled() {
  return g_nat_dump_on.load(std::memory_order_relaxed) != 0;
}

// Seeded deterministic decimation (replayable, not modulo-phased):
// true when THIS call should be captured. Call only when enabled.
bool nat_dump_tick();

// Record one sampled request into this thread's capture ring. verb is
// the HTTP verb for the http lane (nullptr/0 elsewhere). Never blocks;
// ring-full drops are counted.
void nat_dump_sample(int lane, const char* service, size_t service_len,
                     const char* method, size_t method_len,
                     const char* verb, size_t verb_len,
                     const char* payload, size_t payload_len,
                     uint64_t trace_id, uint64_t span_id);
// IOBuf flavor for the tpu_std seam (one copy_to straight into the
// slot/spill, no intermediate flatten).
void nat_dump_sample_iobuf(int lane, const char* service,
                           size_t service_len, const char* method,
                           size_t method_len, const IOBuf& payload,
                           uint64_t trace_id, uint64_t span_id);

// recordio primitives shared with nat_replay.cpp: IEEE CRC-32 (the
// zlib.crc32 polynomial — butil/recordio.py checks it) over two spans.
uint32_t nat_rio_crc32(const char* a, size_t an, const char* b, size_t bn);

}  // namespace brpc_tpu
