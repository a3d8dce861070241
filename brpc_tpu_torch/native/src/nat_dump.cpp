// nat_dump — capture engine of the native traffic flight recorder.
//
// Data path: protocol seam (decimated: nat_dump_tick wins 1-in-N with a
// seeded deterministic decision) -> this thread's DumpCell, a bounded
// SPSC ring claimed by CAS from a fixed pool (the nat_prof cell
// discipline; full ring = counted drop, never a stall) -> background
// writer thread drains every cell into recordio files — the exact
// format butil/recordio.py reads (RIO1 + u32 meta_len + u32 payload_len
// + crc32(meta+payload) + JSON meta + payload) — rotated in generations
// with older files unlinked (the rpcz SpanDB rotation shape).
#include "nat_dump.h"

#include "nat_res.h"

#include <errno.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <string>
#include <thread>
#include <vector>

#include "nat_api.h"
#include "nat_lockrank.h"
#include "nat_stats.h"

namespace brpc_tpu {

std::atomic<uint32_t> g_nat_dump_on{0};

namespace {

// One captured request. Plain fields under the SPSC head/tail protocol:
// the owning thread publishes with a release head bump; the writer
// consumes below head and releases the slot with a release tail bump,
// so the producer can only rewrite a slot the writer is done with.
struct DumpSlot {
  int32_t lane = 0;
  uint32_t payload_len = 0;
  uint16_t service_len = 0;
  uint16_t method_len = 0;
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  uint64_t wall_ns = 0;  // CLOCK_REALTIME capture stamp (meta "ts")
  char verb[kDumpVerbMax] = {0};
  char service[kDumpSvcMax];
  char method[kDumpMethodMax];
  char* spill = nullptr;  // payload_len > kDumpInline: malloc'd, owned
                          // by the slot until the writer frees it
  char inline_payload[kDumpInline];
};

struct DumpCell {
  std::atomic<int32_t> tid{0};     // 0 = free; CAS-claimed by its thread
  std::atomic<uint64_t> head{0};   // producer position (owner thread)
  std::atomic<uint64_t> tail{0};   // consumer position (writer thread)
  DumpSlot ring[kDumpRing];
};

// fixed pool, zero-initialized BSS — the tap claims but never allocates
// cells (a thread keeps its cell across start/stop windows)
DumpCell g_dump_cells[kDumpCells];
// fixed BSS capture pool, attributed for the RSS reconciliation
const bool g_dump_pool_registered = [] {
  NAT_RES_STATIC(NR_PROF_CELLS, sizeof(g_dump_cells));
  return true;
}();

// decimation + caps (relaxed: armed once per window, read per tap)
std::atomic<uint32_t> g_dump_every{1};
std::atomic<uint64_t> g_dump_seed{0};
std::atomic<uint64_t> g_dump_max_payload{1u << 20};

// per-window totals (NatDumpStatusRec); the monotonic cross-window
// totals additionally ride the NS_DUMP_* counters
std::atomic<uint64_t> g_dump_samples{0};
std::atomic<uint64_t> g_dump_written{0};
std::atomic<uint64_t> g_dump_bytes{0};
std::atomic<uint64_t> g_dump_drops{0};
std::atomic<uint64_t> g_dump_oversize{0};
std::atomic<uint64_t> g_dump_rotations{0};

// control plane (start/stop/status): writer lifecycle + file naming.
// The tap path takes NO lock — only the control surface does.
NatMutex<kLockRankDumpCtl> g_dump_ctl_mu;
char g_dump_dir[192] = {0};           // under g_dump_ctl_mu
uint64_t g_dump_max_file_bytes = 0;   // under g_dump_ctl_mu
int g_dump_generations = 4;           // under g_dump_ctl_mu
std::thread* g_dump_writer = nullptr; // under g_dump_ctl_mu
std::atomic<bool> g_dump_writer_stop{false};

// Process-wide generation counter, never reset: a generation NAME must
// never be reused — fopen("wb") on a reused name (second capture
// window into the same dir, or a reopen after a transient write
// failure) would truncate records already persisted under it.
std::atomic<uint64_t> g_dump_gen{0};

// writer-thread-owned file state
struct DumpFileState {
  FILE* f = nullptr;
  uint64_t cur_bytes = 0;
  std::vector<uint64_t> gens;  // generations THIS window wrote, oldest
                               // first (the retention window)
  char dir[192];
  uint64_t max_file_bytes = 0;
  int generations = 4;
};

void dump_gen_path(char* out, size_t n, const char* dir, uint64_t gen) {
  // zero-padded: replay (and the natcheck byte-identity leg) order a
  // directory by NAME sort, which must equal chronological order past
  // generation 9
  snprintf(out, n, "%s/nat_dump.%d.%06llu.rio", dir, (int)getpid(),
           (unsigned long long)gen);
}

// Open the next generation file (a FRESH name from the process-wide
// counter, always), unlinking this window's generations that fall off
// the retention window. False = open failed (capture keeps draining so
// the rings never wedge, but nothing more is persisted this window).
bool dump_rotate(DumpFileState* st) {
  if (st->f != nullptr) {
    fclose(st->f);
    st->f = nullptr;
    g_dump_rotations.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_DUMP_ROTATIONS, 1);
  }
  while (st->gens.size() >= (size_t)st->generations) {
    char old_path[256];
    dump_gen_path(old_path, sizeof(old_path), st->dir, st->gens.front());
    unlink(old_path);
    st->gens.erase(st->gens.begin());
  }
  uint64_t gen = g_dump_gen.fetch_add(1, std::memory_order_relaxed);
  char path[256];
  dump_gen_path(path, sizeof(path), st->dir, gen);
  st->f = fopen(path, "wb");
  st->cur_bytes = 0;
  if (st->f == nullptr) return false;
  st->gens.push_back(gen);
  return true;
}

// IEEE CRC-32 (reflected, poly 0xEDB88320) — bit-identical to Python's
// zlib.crc32, which butil/recordio.py verifies per record. The table is
// compile-time (no lazy init to race, nothing to destruct at exit).
struct Crc32Table {
  uint32_t v[256];
};

constexpr Crc32Table make_crc32_table() {
  Crc32Table t{};
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) {
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    }
    t.v[i] = c;
  }
  return t;
}

constexpr Crc32Table kCrc32Table = make_crc32_table();

uint32_t crc32_update(uint32_t crc, const char* p, size_t n) {
  crc = ~crc;
  for (size_t i = 0; i < n; i++) {
    crc = kCrc32Table.v[(crc ^ (uint8_t)p[i]) & 0xff] ^ (crc >> 8);
  }
  return ~crc;
}

// JSON string escape for method/service names that arrive off the wire
// (paths with quotes/backslashes, control or non-ASCII bytes). Bytes
// past 0x7e escape as \u00XX too: the meta must stay valid UTF-8 JSON
// for Python's json.loads (recordio.py), and the \u00XX form
// round-trips byte-exact through the native replay's unescape.
void json_escape_into(std::string* out, const char* s, size_t n) {
  for (size_t i = 0; i < n; i++) {
    unsigned char c = (unsigned char)s[i];
    if (c == '"' || c == '\\') {
      out->push_back('\\');
      out->push_back((char)c);
    } else if (c < 0x20 || c > 0x7e) {
      char buf[8];
      snprintf(buf, sizeof(buf), "\\u%04x", c);
      out->append(buf);
    } else {
      out->push_back((char)c);
    }
  }
}

// Serialize + append one consumed slot as a recordio record. Meta is a
// flat JSON object readable by tools/rpc_replay.py (service / method /
// log_id / ts) extended with the native fields (lane / verb / trace_id /
// span_id as decimal).
void dump_write_record(DumpFileState* st, DumpSlot* s, std::string* meta) {
  const char* payload =
      s->spill != nullptr ? s->spill : s->inline_payload;
  meta->clear();
  meta->append("{\"service\": \"");
  json_escape_into(meta, s->service, s->service_len);
  meta->append("\", \"method\": \"");
  json_escape_into(meta, s->method, s->method_len);
  meta->append("\", \"log_id\": 0, \"ts\": ");
  // two full 20-digit u64s + keys is ~68 chars: size for the worst case
  char num[96];
  snprintf(num, sizeof(num), "%.6f", (double)s->wall_ns / 1e9);
  meta->append(num);
  meta->append(", \"lane\": \"");
  meta->append(nat_stats_lane_name(s->lane));
  meta->append("\"");
  if (s->verb[0] != '\0') {
    meta->append(", \"verb\": \"");
    json_escape_into(meta, s->verb, strnlen(s->verb, sizeof(s->verb)));
    meta->append("\"");
  }
  snprintf(num, sizeof(num),
           ", \"trace_id\": %llu, \"span_id\": %llu}",
           (unsigned long long)s->trace_id,
           (unsigned long long)s->span_id);
  meta->append(num);

  if (st->f == nullptr || st->cur_bytes >= st->max_file_bytes) {
    if (!dump_rotate(st)) {
      // disk trouble: the ring still drains (recorders must never
      // wedge) but the record is LOST — account it, a zero drops
      // figure must keep meaning "the capture is complete"
      g_dump_drops.fetch_add(1, std::memory_order_relaxed);
      nat_counter_add(NS_DUMP_DROPS, 1);
      return;
    }
  }
  char hdr[16];
  memcpy(hdr, "RIO1", 4);
  uint32_t ml = (uint32_t)meta->size();
  uint32_t pl = s->payload_len;
  uint32_t crc = nat_rio_crc32(meta->data(), ml, payload, pl);
  hdr[4] = (char)(ml >> 24); hdr[5] = (char)(ml >> 16);
  hdr[6] = (char)(ml >> 8);  hdr[7] = (char)ml;
  hdr[8] = (char)(pl >> 24); hdr[9] = (char)(pl >> 16);
  hdr[10] = (char)(pl >> 8); hdr[11] = (char)pl;
  hdr[12] = (char)(crc >> 24); hdr[13] = (char)(crc >> 16);
  hdr[14] = (char)(crc >> 8);  hdr[15] = (char)crc;
  if (fwrite(hdr, 1, 16, st->f) != 16 ||
      fwrite(meta->data(), 1, ml, st->f) != ml ||
      (pl != 0 && fwrite(payload, 1, pl, st->f) != pl)) {
    fclose(st->f);  // write error (disk full): stop persisting
    st->f = nullptr;
    g_dump_drops.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_DUMP_DROPS, 1);
    return;
  }
  uint64_t rec_bytes = 16u + ml + pl;
  st->cur_bytes += rec_bytes;
  g_dump_written.fetch_add(1, std::memory_order_relaxed);
  g_dump_bytes.fetch_add(rec_bytes, std::memory_order_relaxed);
  nat_counter_add(NS_DUMP_RECORDS_WRITTEN, 1);
  nat_counter_add(NS_DUMP_BYTES_WRITTEN, rec_bytes);
}

// Drain every cell's published samples into the capture file. Writer
// thread only. Returns the number of records consumed.
int dump_drain_pass(DumpFileState* st, std::string* meta) {
  int consumed = 0;
  for (int i = 0; i < kDumpCells; i++) {
    DumpCell* c = &g_dump_cells[i];
    if (c->tid.load(std::memory_order_acquire) == 0) continue;
    uint64_t head = c->head.load(std::memory_order_acquire);
    uint64_t tail = c->tail.load(std::memory_order_relaxed);
    while (tail < head) {
      DumpSlot* s = &c->ring[tail & (kDumpRing - 1)];
      dump_write_record(st, s, meta);
      if (s->spill != nullptr) {
        NAT_RES_FREE(NR_DUMP_SPILL, s->payload_len, s->spill);
      }
      free(s->spill);
      s->spill = nullptr;
      tail++;
      // release per slot: the producer's ring-full check may admit a
      // new sample into this slot the moment the bump is visible
      c->tail.store(tail, std::memory_order_release);
      consumed++;
    }
  }
  return consumed;
}

void dump_writer_loop(DumpFileState st) {
  std::string meta;
  meta.reserve(512);
  while (!g_dump_writer_stop.load(std::memory_order_acquire)) {
    if (dump_drain_pass(&st, &meta) > 0 && st.f != nullptr) {
      fflush(st.f);  // a capture must survive a crash of the embedder
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  dump_drain_pass(&st, &meta);  // final sweep after the stop flag
  if (st.f != nullptr) fclose(st.f);
}

// Claim (or find) this thread's cell — open addressing over the fixed
// pool, CAS on the tid word (the nat_prof claim discipline).
DumpCell* dump_cell(int32_t tid) {
  uint32_t h = (uint32_t)(nat_mix64((uint64_t)tid) % kDumpCells);
  for (int probe = 0; probe < kDumpCells; probe++) {
    DumpCell* c = &g_dump_cells[(h + (uint32_t)probe) % kDumpCells];
    int32_t cur = c->tid.load(std::memory_order_acquire);
    if (cur == tid) return c;
    if (cur == 0) {
      int32_t expect = 0;
      if (c->tid.compare_exchange_strong(expect, tid,
                                         std::memory_order_acq_rel)) {
        return c;
      }
      if (expect == tid) return c;
    }
  }
  return nullptr;  // pool full: drop the sample
}

thread_local DumpCell* tls_dump_cell = nullptr;

uint64_t wall_now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// Reserve this thread's next ring slot, or account the drop. The
// caller fills the slot and MUST follow with dump_publish.
DumpSlot* dump_reserve(DumpCell** cell_out) {
  DumpCell* cell = tls_dump_cell;
  if (cell == nullptr) {
    cell = dump_cell((int32_t)syscall(SYS_gettid));
    if (cell == nullptr) {
      g_dump_drops.fetch_add(1, std::memory_order_relaxed);
      nat_counter_add(NS_DUMP_DROPS, 1);
      return nullptr;
    }
    tls_dump_cell = cell;
  }
  uint64_t head = cell->head.load(std::memory_order_relaxed);
  if (head - cell->tail.load(std::memory_order_acquire) >= kDumpRing) {
    g_dump_drops.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_DUMP_DROPS, 1);
    return nullptr;  // writer behind: drop, never stall the seam
  }
  *cell_out = cell;
  return &cell->ring[head & (kDumpRing - 1)];
}

void dump_publish(DumpCell* cell) {
  cell->head.store(cell->head.load(std::memory_order_relaxed) + 1,
                   std::memory_order_release);
  g_dump_samples.fetch_add(1, std::memory_order_relaxed);
  nat_counter_add(NS_DUMP_SAMPLES, 1);
}

// Common slot fill minus the payload bytes. False = oversize skip.
bool dump_fill_header(DumpSlot* s, int lane, const char* service,
                      size_t service_len, const char* method,
                      size_t method_len, const char* verb,
                      size_t verb_len, size_t payload_len,
                      uint64_t trace_id, uint64_t span_id) {
  if (payload_len > g_dump_max_payload.load(std::memory_order_relaxed) ||
      service_len >= (size_t)kDumpSvcMax ||
      method_len >= (size_t)kDumpMethodMax) {
    // a truncated request is not replayable (and a truncated METHOD
    // would replay the WRONG endpoint): skip it whole, counted
    g_dump_oversize.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_DUMP_OVERSIZE, 1);
    return false;
  }
  s->lane = lane;
  s->payload_len = (uint32_t)payload_len;
  s->service_len = (uint16_t)service_len;
  memcpy(s->service, service, s->service_len);
  s->method_len = (uint16_t)method_len;
  memcpy(s->method, method, s->method_len);
  size_t vl = verb_len < sizeof(s->verb) - 1 ? verb_len
                                             : sizeof(s->verb) - 1;
  if (verb != nullptr && vl != 0) memcpy(s->verb, verb, vl);
  s->verb[verb != nullptr ? vl : 0] = '\0';
  s->trace_id = trace_id;
  s->span_id = span_id;
  s->wall_ns = wall_now_ns();
  if (payload_len > kDumpInline) {
    s->spill = (char*)malloc(payload_len);
    if (s->spill == nullptr) {
      g_dump_drops.fetch_add(1, std::memory_order_relaxed);
      nat_counter_add(NS_DUMP_DROPS, 1);
      return false;
    }
    NAT_RES_ALLOC(NR_DUMP_SPILL, payload_len, s->spill);
  }
  return true;
}

}  // namespace

bool nat_dump_tick() {
  uint32_t every = g_dump_every.load(std::memory_order_relaxed);
  if (every <= 1) return true;
  // seeded decimation, deterministic per thread for a given seed (the
  // natfault / mu-prof decision discipline — replayable, not phased)
  static thread_local uint64_t n = 0;
  return nat_mix64(g_dump_seed.load(std::memory_order_relaxed) ^ ++n) %
             every ==
         0;
}

void nat_dump_sample(int lane, const char* service, size_t service_len,
                     const char* method, size_t method_len,
                     const char* verb, size_t verb_len,
                     const char* payload, size_t payload_len,
                     uint64_t trace_id, uint64_t span_id) {
  DumpCell* cell = nullptr;
  DumpSlot* s = dump_reserve(&cell);
  if (s == nullptr) return;
  if (!dump_fill_header(s, lane, service, service_len, method, method_len,
                        verb, verb_len, payload_len, trace_id, span_id)) {
    return;  // slot not published: the next sample reuses it
  }
  char* dst = s->spill != nullptr ? s->spill : s->inline_payload;
  if (payload_len != 0) memcpy(dst, payload, payload_len);
  dump_publish(cell);
}

void nat_dump_sample_iobuf(int lane, const char* service,
                           size_t service_len, const char* method,
                           size_t method_len, const IOBuf& payload,
                           uint64_t trace_id, uint64_t span_id) {
  DumpCell* cell = nullptr;
  DumpSlot* s = dump_reserve(&cell);
  if (s == nullptr) return;
  if (!dump_fill_header(s, lane, service, service_len, method, method_len,
                        nullptr, 0, payload.length(), trace_id,
                        span_id)) {
    return;
  }
  char* dst = s->spill != nullptr ? s->spill : s->inline_payload;
  if (!payload.empty()) payload.copy_to(dst, payload.length());
  dump_publish(cell);
}

uint32_t nat_rio_crc32(const char* a, size_t an, const char* b,
                       size_t bn) {
  // zlib-chained: crc32(b, crc32(a, 0)) == crc32(a+b, 0)
  uint32_t crc = crc32_update(0, a, an);
  return crc32_update(crc, b, bn);
}

}  // namespace brpc_tpu

using namespace brpc_tpu;

extern "C" {

// Arm the flight recorder: sample 1-in-`every` requests at the native
// seams into `dir` (created if missing), rotating files past
// max_file_bytes and keeping `generations` of them. Returns 0,
// -1 = already running, -2 = dir not creatable.
int nat_dump_start(const char* dir, int every, uint64_t seed,
                   uint64_t max_file_bytes, int generations,
                   uint64_t max_payload) {
  if (dir == nullptr || dir[0] == '\0') return -2;
  std::lock_guard g(g_dump_ctl_mu);
  if (g_nat_dump_on.load(std::memory_order_acquire) != 0) return -1;
  if (mkdir(dir, 0777) != 0 && errno != EEXIST) return -2;
  snprintf(g_dump_dir, sizeof(g_dump_dir), "%s", dir);
  g_dump_every.store(every > 1 ? (uint32_t)every : 1,
                     std::memory_order_relaxed);
  g_dump_seed.store(seed, std::memory_order_relaxed);
  g_dump_max_file_bytes =
      max_file_bytes > 0 ? max_file_bytes : (64ull << 20);
  g_dump_generations = generations > 0 ? generations : 4;
  g_dump_max_payload.store(max_payload > 0 ? max_payload : (1u << 20),
                           std::memory_order_relaxed);
  g_dump_samples.store(0, std::memory_order_relaxed);
  g_dump_written.store(0, std::memory_order_relaxed);
  g_dump_bytes.store(0, std::memory_order_relaxed);
  g_dump_drops.store(0, std::memory_order_relaxed);
  g_dump_oversize.store(0, std::memory_order_relaxed);
  g_dump_rotations.store(0, std::memory_order_relaxed);
  // discard samples stranded by a straggling recorder of the PREVIOUS
  // window (published after its final drain): stale requests must not
  // leak into this window's files
  for (int i = 0; i < kDumpCells; i++) {
    DumpCell* c = &g_dump_cells[i];
    uint64_t head = c->head.load(std::memory_order_acquire);
    uint64_t tail = c->tail.load(std::memory_order_relaxed);
    while (tail < head) {
      DumpSlot* s = &c->ring[tail & (kDumpRing - 1)];
      if (s->spill != nullptr) {
        NAT_RES_FREE(NR_DUMP_SPILL, s->payload_len, s->spill);
      }
      free(s->spill);
      s->spill = nullptr;
      tail++;
    }
    c->tail.store(tail, std::memory_order_release);
  }
  DumpFileState st;
  snprintf(st.dir, sizeof(st.dir), "%s", g_dump_dir);
  st.max_file_bytes = g_dump_max_file_bytes;
  st.generations = g_dump_generations;
  if (!dump_rotate(&st)) return -2;  // first file must open
  g_dump_writer_stop.store(false, std::memory_order_release);
  // heap-held + joined in stop — never a static std::thread (the
  // static-dtor exit-crash class)
  // natcheck:allow(resacct): control-plane thread handle, joined in stop
  g_dump_writer = new std::thread(dump_writer_loop, std::move(st));
  g_nat_dump_on.store(1, std::memory_order_release);
  return 0;
}

// Disarm: stop sampling, drain the rings, flush + close the current
// file. Safe when not running.
int nat_dump_stop(void) {
  std::lock_guard g(g_dump_ctl_mu);
  if (g_nat_dump_on.exchange(0, std::memory_order_acq_rel) == 0) {
    return 0;
  }
  if (g_dump_writer != nullptr) {
    g_dump_writer_stop.store(true, std::memory_order_release);
    // natcheck:allow(lock-switch): control path on embedder threads
    // (never a fiber); ctl is held ON PURPOSE so a concurrent start
    // cannot spawn a second writer while this one is joining
    g_dump_writer->join();
    delete g_dump_writer;
    g_dump_writer = nullptr;
  }
  return 0;
}

int nat_dump_running(void) {
  return g_nat_dump_on.load(std::memory_order_acquire) != 0 ? 1 : 0;
}

// Status snapshot for /rpc_dump (counts are since the current start;
// config reflects the armed window, or the last one when stopped).
int nat_dump_status(brpc_tpu::NatDumpStatusRec* out) {
  if (out == nullptr) return -1;
  memset(out, 0, sizeof(*out));
  out->samples = g_dump_samples.load(std::memory_order_relaxed);
  out->written = g_dump_written.load(std::memory_order_relaxed);
  out->bytes = g_dump_bytes.load(std::memory_order_relaxed);
  out->drops = g_dump_drops.load(std::memory_order_relaxed);
  out->oversize = g_dump_oversize.load(std::memory_order_relaxed);
  out->rotations = g_dump_rotations.load(std::memory_order_relaxed);
  out->max_payload = g_dump_max_payload.load(std::memory_order_relaxed);
  out->seed = g_dump_seed.load(std::memory_order_relaxed);
  out->every = g_dump_every.load(std::memory_order_relaxed);
  out->running = g_nat_dump_on.load(std::memory_order_acquire) ? 1 : 0;
  std::lock_guard g(g_dump_ctl_mu);
  out->max_file_bytes = g_dump_max_file_bytes;
  out->generations = g_dump_generations;
  snprintf(out->dir, sizeof(out->dir), "%s", g_dump_dir);
  return 0;
}

}  // extern "C"
