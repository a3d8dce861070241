// nat_replay — native replay/press client of the traffic flight
// recorder (rpc_replay + rpc_press's C++ twin, SURVEY §2.11).
//
// Reads recordio capture files (nat_dump.cpp's writer, or the Python
// rpc_dump's — same format, butil/recordio.py), then re-fires the
// replayable records through the REAL native client lanes — tpu_std
// via NatChannel sync calls, HTTP via the native HTTP client lane,
// gRPC via the native h2 lane — from a pool of worker threads at a
// controlled (optionally ramped) rate, recording latency into a log2
// histogram. qps 0 = press mode: no throttle, `concurrency` callers
// back to back. This turns any production-shaped capture into a
// standing bench lane (ROADMAP item 4's load generator).
#include <dirent.h>
#include <math.h>
#include <unistd.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <string>
#include <thread>
#include <vector>

#include "nat_api.h"
#include "nat_dump.h"
#include "nat_stats.h"

namespace brpc_tpu {
namespace {

// total payload bytes loaded into memory before loading stops (a
// multi-GB capture replays its first GB rather than OOMing the caller)
inline constexpr uint64_t kReplayMaxLoadBytes = 1ull << 30;

struct ReplayRec {
  int lane = NL_ECHO;
  std::string verb;     // http only ("" = derive from payload presence)
  std::string service;  // tpu_std only
  std::string method;   // tpu_std method / http path / grpc :path
  std::string payload;
};

// ---- minimal JSON field extraction over the flat meta object --------------
// (both writers emit one flat object with string/number values; a full
// parser would be dead weight here)

bool json_find_string(const std::string& meta, const char* key,
                      std::string* out) {
  std::string needle = std::string("\"") + key + "\"";
  size_t p = meta.find(needle);
  if (p == std::string::npos) return false;
  p += needle.size();
  while (p < meta.size() && (meta[p] == ' ' || meta[p] == ':')) p++;
  if (p >= meta.size() || meta[p] != '"') return false;
  p++;
  out->clear();
  while (p < meta.size() && meta[p] != '"') {
    char c = meta[p];
    if (c == '\\' && p + 1 < meta.size()) {
      char e = meta[p + 1];
      p += 2;
      switch (e) {
        case 'n': out->push_back('\n'); break;
        case 't': out->push_back('\t'); break;
        case 'r': out->push_back('\r'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case 'u': {
          if (p + 4 <= meta.size()) {
            unsigned v = (unsigned)strtoul(
                meta.substr(p, 4).c_str(), nullptr, 16);
            p += 4;
            if (v >= 0xd800 && v < 0xdc00 && p + 6 <= meta.size() &&
                meta[p] == '\\' && meta[p + 1] == 'u') {
              // surrogate pair (json.dumps for astral-plane text):
              // combine into one codepoint, emit 4-byte UTF-8
              unsigned lo = (unsigned)strtoul(
                  meta.substr(p + 2, 4).c_str(), nullptr, 16);
              if (lo >= 0xdc00 && lo < 0xe000) {
                p += 6;
                unsigned cp = 0x10000 + ((v - 0xd800) << 10) +
                              (lo - 0xdc00);
                out->push_back((char)(0xf0 | (cp >> 18)));
                out->push_back((char)(0x80 | ((cp >> 12) & 0x3f)));
                out->push_back((char)(0x80 | ((cp >> 6) & 0x3f)));
                out->push_back((char)(0x80 | (cp & 0x3f)));
                break;
              }
            }
            if (v < 0x100) {
              // \u00XX is a raw wire byte (the native writer's
              // escaping, RECORDIO.md) — byte-exact round trip
              out->push_back((char)v);
            } else if (v < 0x800) {
              // higher codepoints (Python json.dumps ensure_ascii on
              // real text) re-encode as the UTF-8 bytes the Python
              // channel would put on the wire
              out->push_back((char)(0xc0 | (v >> 6)));
              out->push_back((char)(0x80 | (v & 0x3f)));
            } else {
              out->push_back((char)(0xe0 | (v >> 12)));
              out->push_back((char)(0x80 | ((v >> 6) & 0x3f)));
              out->push_back((char)(0x80 | (v & 0x3f)));
            }
          }
          break;
        }
        default: out->push_back(e); break;
      }
      continue;
    }
    out->push_back(c);
    p++;
  }
  return p < meta.size();
}

int lane_from_meta(const std::string& meta) {
  std::string lane;
  if (!json_find_string(meta, "lane", &lane)) {
    return NL_ECHO;  // Python rpc_dump files: tpu_std by construction
  }
  for (int i = 0; i < NL_LANE_COUNT; i++) {
    if (lane == nat_stats_lane_name(i)) return i;
  }
  return -1;
}

// ---- recordio reader ------------------------------------------------------

uint32_t rd32(const unsigned char* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// Append the replayable records of one .rio file. A clean truncated
// tail (EOF mid-record: the writer was killed mid-capture) is
// tolerated; a bad magic, insane length or CRC mismatch stops this
// file AND counts one `skipped` — the Python reader raises on the
// same bytes, so a corrupt stream must never read as a smaller
// successful load.
void load_file(const char* path, std::vector<ReplayRec>* out,
               uint64_t* loaded, uint64_t* skipped,
               uint64_t* loaded_bytes) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return;
  // the claimed record lengths below must also fit the bytes actually
  // on disk: a 16-byte forged file claiming pl=512MB must not force a
  // 512MB zero-filled resize before fread discovers the truncation
  struct stat st;
  if (fstat(fileno(f), &st) != 0 || st.st_size < 0) {
    fclose(f);
    return;
  }
  uint64_t remaining = (uint64_t)st.st_size;
  std::string meta, payload;
  for (;;) {
    unsigned char hdr[16];
    if (fread(hdr, 1, 16, f) != 16) break;  // EOF / truncated tail
    remaining = remaining >= 16 ? remaining - 16 : 0;
    uint32_t ml = NAT_WIRE(rd32(hdr + 4));
    uint32_t pl = NAT_WIRE(rd32(hdr + 8));
    uint32_t crc = NAT_WIRE(rd32(hdr + 12));
    if (memcmp(hdr, "RIO1", 4) != 0 || ml > (1u << 20) ||
        pl > (512u << 20) || (uint64_t)ml + pl > remaining) {
      (*skipped)++;  // corrupt stream: the file's remainder is lost
      break;
    }
    remaining -= (uint64_t)ml + pl;
    meta.resize(ml);
    payload.resize(pl);
    if (ml != 0 && fread(&meta[0], 1, ml, f) != ml) break;
    if (pl != 0 && fread(&payload[0], 1, pl, f) != pl) break;
    if (nat_rio_crc32(meta.data(), ml, payload.data(), pl) != crc) {
      (*skipped)++;  // corrupt record: remainder unparseable
      break;
    }
    (*loaded)++;
    int lane = lane_from_meta(meta);
    ReplayRec rec;
    bool replayable = false;
    if (lane == NL_ECHO) {
      // tpu_std: service + method, re-fired through NatChannel
      if (json_find_string(meta, "service", &rec.service) &&
          json_find_string(meta, "method", &rec.method)) {
        replayable = true;
      }
    } else if (lane == NL_HTTP) {
      if (json_find_string(meta, "method", &rec.method) &&
          !rec.method.empty() && rec.method[0] == '/') {
        json_find_string(meta, "verb", &rec.verb);
        replayable = true;
      }
    } else if (lane == NL_GRPC) {
      if (json_find_string(meta, "method", &rec.method) &&
          !rec.method.empty() && rec.method[0] == '/') {
        replayable = true;
      }
    }
    // redis / worker / client records have no NatChannel client lane
    // to re-fire through: counted, never silently vanished
    if (!replayable) {
      (*skipped)++;
      continue;
    }
    rec.lane = lane;
    rec.payload = payload;
    *loaded_bytes += pl;
    out->push_back(std::move(rec));
    if (*loaded_bytes > kReplayMaxLoadBytes) break;
  }
  fclose(f);
}

// `files` is a ';'-separated list of .rio paths and/or directories
// (directories are scanned for *.rio in name order — capture
// generations sort chronologically by construction).
void load_spec(const char* files, std::vector<ReplayRec>* out,
               uint64_t* loaded, uint64_t* skipped) {
  uint64_t loaded_bytes = 0;
  std::string spec(files != nullptr ? files : "");
  size_t pos = 0;
  while (pos <= spec.size()) {
    size_t sep = spec.find(';', pos);
    if (sep == std::string::npos) sep = spec.size();
    std::string tok = spec.substr(pos, sep - pos);
    pos = sep + 1;
    if (tok.empty()) continue;
    struct stat st;
    if (stat(tok.c_str(), &st) != 0) continue;
    if (S_ISDIR(st.st_mode)) {
      std::vector<std::string> names;
      if (DIR* d = opendir(tok.c_str())) {
        while (struct dirent* e = readdir(d)) {
          size_t n = strlen(e->d_name);
          if (n > 4 && strcmp(e->d_name + n - 4, ".rio") == 0) {
            names.push_back(tok + "/" + e->d_name);
          }
        }
        closedir(d);
      }
      std::sort(names.begin(), names.end());
      for (const std::string& p : names) {
        load_file(p.c_str(), out, loaded, skipped, &loaded_bytes);
      }
    } else {
      load_file(tok.c_str(), out, loaded, skipped, &loaded_bytes);
    }
  }
}

// ---- rate schedule --------------------------------------------------------

// Fire time (seconds from run start) of request k under a linear ramp
// from q0 to q1 qps across N total requests (q1 <= 0 = constant q0).
// Solves the cumulative-count integral q0*t + (q1-q0)/(2T)*t^2 = k.
double fire_time(uint64_t k, double q0, double q1, uint64_t n_total) {
  if (q0 <= 0.0) return 0.0;  // press mode: no schedule
  if (q1 <= 0.0 || q1 == q0 || n_total == 0) return (double)k / q0;
  double T = 2.0 * (double)n_total / (q0 + q1);
  double a = (q1 - q0) / (2.0 * T);
  double disc = q0 * q0 + 4.0 * a * (double)k;
  if (disc < 0.0) disc = 0.0;
  return (-q0 + sqrt(disc)) / (2.0 * a);
}

struct ReplayShared {
  const std::vector<ReplayRec>* recs = nullptr;
  std::atomic<uint64_t> next{0};
  uint64_t total = 0;  // records x times
  double q0 = 0.0, q1 = 0.0;
  int timeout_ms = 0;
  std::chrono::steady_clock::time_point t0;
  void* ch_std = nullptr;
  void* ch_http = nullptr;
  void* ch_grpc = nullptr;
  std::atomic<uint64_t> ok{0};
  std::atomic<uint64_t> failed{0};
  std::atomic<uint64_t> hist[kNatHistBuckets] = {};
};

// Fire one record through its lane's public sync client surface — the
// exact calls a ctypes embedder makes, so a replay run exercises the
// production client path end to end.
bool fire_one(ReplayShared* sh, const ReplayRec& r) {
  char* resp = nullptr;
  size_t rlen = 0;
  char* err = nullptr;
  bool ok = false;
  if (r.lane == NL_ECHO) {
    int rc = nat_channel_call_full(
        sh->ch_std, r.service.c_str(), r.method.c_str(), r.payload.data(),
        r.payload.size(), sh->timeout_ms, 0, 0, &resp, &rlen, &err);
    ok = rc == 0;
  } else if (r.lane == NL_HTTP) {
    const char* verb = !r.verb.empty() ? r.verb.c_str()
                       : r.payload.empty() ? "GET"
                                           : "POST";
    int status = 0;
    int rc = nat_http_call(sh->ch_http, verb, r.method.c_str(), nullptr,
                           r.payload.data(), r.payload.size(),
                           sh->timeout_ms, &status, &resp, &rlen);
    ok = rc == 0 && status / 100 == 2;
  } else {  // NL_GRPC
    int gst = -1;
    int rc = nat_grpc_call(sh->ch_grpc, r.method.c_str(),
                           r.payload.data(), r.payload.size(),
                           sh->timeout_ms, &gst, &resp, &rlen, &err);
    ok = rc == 0 && gst == 0;
  }
  if (resp != nullptr) nat_buf_free(resp);
  if (err != nullptr) nat_buf_free(err);
  return ok;
}

void replay_worker(ReplayShared* sh) {
  const std::vector<ReplayRec>& recs = *sh->recs;
  for (;;) {
    uint64_t k = sh->next.fetch_add(1, std::memory_order_relaxed);
    if (k >= sh->total) return;
    if (sh->q0 > 0.0) {
      auto due = sh->t0 + std::chrono::duration_cast<
                              std::chrono::steady_clock::duration>(
                              std::chrono::duration<double>(fire_time(
                                  k, sh->q0, sh->q1, sh->total)));
      std::this_thread::sleep_until(due);
    }
    const ReplayRec& r = recs[k % recs.size()];
    nat_counter_add(NS_REPLAY_CALLS, 1);
    uint64_t c0 = nat_now_ns();
    bool ok = fire_one(sh, r);
    uint64_t lat = nat_now_ns() - c0;
    if (ok) {
      sh->ok.fetch_add(1, std::memory_order_relaxed);
      sh->hist[nat_hist_bucket(lat)].fetch_add(1,
                                               std::memory_order_relaxed);
    } else {
      sh->failed.fetch_add(1, std::memory_order_relaxed);
      nat_counter_add(NS_REPLAY_ERRORS, 1);
    }
  }
}

// log2-bucket quantile (ns) over the run-local histogram: snapshot the
// atomics, then the SHARED nat_hist_quantile interpolation (nat_stats).
double replay_quantile_ns(const std::atomic<uint64_t>* hist, double q) {
  uint64_t buckets[kNatHistBuckets];
  for (int b = 0; b < kNatHistBuckets; b++) {
    buckets[b] = hist[b].load(std::memory_order_relaxed);
  }
  return nat_hist_quantile(buckets, kNatHistBuckets, q);
}

}  // namespace

// Fuzz seam (nat_fuzz_entry.cpp owns the others; this one lives here
// for the anonymous-namespace load_file): round an arbitrary byte
// image through a temp file into the real recordio CRC/bounds loader.
extern "C" int nat_fuzz_recordio(const char* data, size_t len) {
  char path[] = "/tmp/nat_fuzz_rio_XXXXXX";
  int fd = mkstemp(path);
  if (fd < 0) return 0;
  size_t off = 0;
  while (off < len) {
    ssize_t w = write(fd, data + off, len - off);
    if (w <= 0) break;
    off += (size_t)w;
  }
  ::close(fd);
  std::vector<ReplayRec> recs;
  uint64_t loaded = 0, skipped = 0, loaded_bytes = 0;
  load_file(path, &recs, &loaded, &skipped, &loaded_bytes);
  unlink(path);
  return loaded != 0 ? 1 : 0;
}

}  // namespace brpc_tpu

using namespace brpc_tpu;

extern "C" {

// Replay captured traffic against ip:port. `files` = ';'-separated
// .rio paths / directories. `times` repeats the record list (>= 1).
// qps_from > 0 throttles the fire schedule (qps_to > 0 ramps linearly
// to it across the run); qps_from <= 0 = press mode (no throttle,
// `concurrency` callers back to back). Latency quantiles cover
// successful calls. Returns 0, -1 = no replayable records,
// -2 = channel open failed.
int nat_replay_run(const char* ip, int port, const char* files, int times,
                   double qps_from, double qps_to, int concurrency,
                   int timeout_ms, brpc_tpu::NatReplayResult* out) {
  if (out == nullptr) return -1;
  memset(out, 0, sizeof(*out));
  std::vector<ReplayRec> recs;
  uint64_t loaded = 0, skipped = 0;
  load_spec(files, &recs, &loaded, &skipped);
  if (times < 1) times = 1;
  out->loaded = loaded;
  out->skipped = skipped * (uint64_t)times;
  if (recs.empty()) return -1;

  ReplayShared sh;
  sh.recs = &recs;
  sh.total = (uint64_t)recs.size() * (uint64_t)times;
  sh.q0 = qps_from;
  sh.q1 = qps_to;
  sh.timeout_ms = timeout_ms;
  bool need_std = false, need_http = false, need_grpc = false;
  for (const ReplayRec& r : recs) {
    need_std |= r.lane == NL_ECHO;
    need_http |= r.lane == NL_HTTP;
    need_grpc |= r.lane == NL_GRPC;
  }
  if (need_std) {
    sh.ch_std = nat_channel_open(ip, port, 0, 1, 5000, 0);
    if (sh.ch_std == nullptr) return -2;
  }
  if (need_http) {
    sh.ch_http =
        nat_channel_open_proto(ip, port, 0, 0, 5000, 0, 1, nullptr);
  }
  if (need_grpc) {
    sh.ch_grpc =
        nat_channel_open_proto(ip, port, 0, 0, 5000, 0, 2, nullptr);
  }
  if ((need_http && sh.ch_http == nullptr) ||
      (need_grpc && sh.ch_grpc == nullptr)) {
    if (sh.ch_std != nullptr) nat_channel_close(sh.ch_std);
    if (sh.ch_http != nullptr) nat_channel_close(sh.ch_http);
    return -2;
  }

  if (concurrency < 1) concurrency = 1;
  if (concurrency > 64) concurrency = 64;
  sh.t0 = std::chrono::steady_clock::now();
  std::vector<std::thread> workers;
  workers.reserve((size_t)concurrency);
  for (int i = 0; i < concurrency; i++) {
    workers.emplace_back(replay_worker, &sh);
  }
  for (auto& t : workers) t.join();
  double dt = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - sh.t0)
                  .count();

  if (sh.ch_std != nullptr) nat_channel_close(sh.ch_std);
  if (sh.ch_http != nullptr) nat_channel_close(sh.ch_http);
  if (sh.ch_grpc != nullptr) nat_channel_close(sh.ch_grpc);

  out->sent = sh.total;
  out->ok = sh.ok.load(std::memory_order_relaxed);
  out->failed = sh.failed.load(std::memory_order_relaxed);
  out->seconds = dt;
  out->qps = dt > 0 ? (double)(out->ok + out->failed) / dt : 0.0;
  out->p50_us = replay_quantile_ns(sh.hist, 0.50) / 1e3;
  out->p99_us = replay_quantile_ns(sh.hist, 0.99) / 1e3;
  return 0;
}

}  // extern "C"
