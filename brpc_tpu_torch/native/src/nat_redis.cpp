// Native Redis lane — RESP command parse in the native cut loop, replies
// in strict command order, usercode split between a native in-memory
// store (GET/SET family, the fully-native fast path) and the Python
// RedisService handlers (kind-6 py lane) for everything else.
//
// Reference shape: the fork wires redis into the io_uring datapath
// (policy/redis_protocol.cpp:38,175 — ring write buf pool + ring_buf)
// and dispatches to RedisService::CommandHandler user hooks (redis.h).
// Here the parse and the hot commands are C++; unknown commands keep the
// Python handler surface. Reply ordering across the two lanes rides a
// per-session (seq -> reply) reorder window with a round-active flag so
// a py reply can never overtake a native reply still parked in the
// reading thread's per-round accumulator.
#include "nat_internal.h"

namespace brpc_tpu {

static constexpr size_t kMaxRedisArgs = 1024 * 1024;
static constexpr size_t kMaxRedisCommandBytes = 64u << 20;

struct RedisSessN {
  // written by the reading thread only (relaxed RMW); the quiesce drain
  // predicate and the lame-duck close read it cross-thread (advisory)
  std::atomic<uint64_t> next_req_seq{1};
  // A partial command's known minimum total size: skip re-copying the
  // buffer every read burst while a big bulk value trickles in
  // (reading thread only).
  size_t need_bytes = 0;
  NatMutex<kLockRankRedisSess> redis_mu;  // guards everything below (py pthreads + reading thread)
  uint64_t next_resp_seq = 1;
  std::map<uint64_t, std::string> parked;
  // The reading thread is mid-round with possibly-unflushed replies in
  // its batch accumulator: py emissions must park instead of writing
  // directly, or a later seq could hit the write queue first.
  bool round_active = false;
  // QUIT discipline: close only once the reply for this seq has been
  // drained AND queued to the socket (setting close_after_drain at
  // parse time could fail the socket while +OK still sits in the batch
  // accumulator).
  uint64_t close_after_seq = 0;
  bool close_pending = false;  // drained mid-round; arm at round end
  // Lame duck (server quiesce): close as soon as the reply window owes
  // nothing — every admitted command answers before the FIN (under mu).
  bool lame_duck = false;
};

// Arm close-after-drain NOW, with the recheck http_emit_response does:
// the reply's write may have drained synchronously before the flag was
// visible to it, in which case nothing else will ever check the flag.
static void redis_arm_close(NatSocket* s) {
  // flag + seq_cst fence + idle recheck, Dekker-paired with the drain
  // role's release (the reply's write may have drained synchronously
  // before the flag was visible)
  s->arm_close_after_drain();
}

void redis_session_free(RedisSessN* h) { delete h; }

// Lame-duck this RESP session (quiesce phase 2): once every admitted
// command's reply has drained through the ordered window, the
// connection closes (reply first, FIN after). Idle sessions close now.
void redis_session_lame_duck(NatSocket* s) {
  RedisSessN* h = s->redis;
  if (h == nullptr) return;
  bool idle;
  {
    std::lock_guard g(h->redis_mu);
    h->lame_duck = true;
    idle = h->parked.empty() &&
           h->next_resp_seq ==
               h->next_req_seq.load(std::memory_order_relaxed);
  }
  if (idle) s->arm_close_after_drain();
}

// Replies still owed on this session? (quiesce drain predicate)
bool redis_session_busy(NatSocket* s) {
  RedisSessN* h = s->redis;
  if (h == nullptr) return false;
  std::lock_guard g(h->redis_mu);
  return !h->parked.empty() ||
         h->next_resp_seq != h->next_req_seq.load(std::memory_order_relaxed);
}

struct RedisStoreN {
  NatMutex<kLockRankRedisStore> store_mu;
  std::unordered_map<std::string, std::string> kv;
};

void redis_store_free(RedisStoreN* st) { delete st; }
RedisStoreN* redis_store_new() { return new RedisStoreN(); }

// -- reply encoding helpers -------------------------------------------------

static void r_status(std::string* out, const char* s) {
  out->push_back('+');
  out->append(s);
  out->append("\r\n");
}
static void r_error(std::string* out, const std::string& s) {
  out->push_back('-');
  out->append(s);
  out->append("\r\n");
}
static void r_int(std::string* out, int64_t v) {
  char buf[32];
  int n = snprintf(buf, sizeof(buf), ":%lld\r\n", (long long)v);
  out->append(buf, n);
}
static void r_bulk(std::string* out, const std::string& v) {
  char buf[32];
  int n = snprintf(buf, sizeof(buf), "$%zu\r\n", v.size());
  out->append(buf, n);
  out->append(v);
  out->append("\r\n");
}
static void r_nil(std::string* out) { out->append("$-1\r\n"); }

// -- ordered emission -------------------------------------------------------

// Drain in-order parked replies. Requires h->redis_mu. Appends to out;
// *want_close set when the QUIT reply drained.
static void redis_drain_locked(NatSocket* s, RedisSessN* h,
                               std::string* out, bool* want_close) {
  while (true) {
    auto it = h->parked.find(h->next_resp_seq);
    if (it == h->parked.end()) break;
    s->conn_parked_sub(it->second.size());
    out->append(it->second);
    h->parked.erase(it);
    if (h->close_after_seq != 0 &&
        h->next_resp_seq == h->close_after_seq) {
      *want_close = true;
    }
    h->next_resp_seq++;
  }
  // lame duck: window owes nothing — close after the last reply byte
  // (the racy next_req_seq read is settled by the quiesce double-poll)
  if (h->lame_duck && h->parked.empty() &&
      h->next_resp_seq ==
          h->next_req_seq.load(std::memory_order_relaxed)) {
    *want_close = true;
  }
}

// Queue reply for `seq` preserving command order. batch_out != nullptr
// only on the reading thread.
static void redis_emit(NatSocket* s, RedisSessN* h, uint64_t seq,
                       std::string&& reply, IOBuf* batch_out) {
  nat_counter_add(NS_REDIS_RESPONSES_OUT, 1);
  s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  std::string out;
  bool want_close = false;
  {
    std::lock_guard g(h->redis_mu);
    std::string& slot = h->parked[seq];
    slot = std::move(reply);
    s->conn_parked_add(slot.size());
    if (batch_out == nullptr && h->round_active) {
      // the reading thread holds unflushed earlier replies in its round
      // accumulator: writing now could overtake them. It drains the
      // window at end of round.
      return;
    }
    redis_drain_locked(s, h, &out, &want_close);
    if (batch_out != nullptr) {
      // mid-round: the bytes flush at end of round; closing must wait
      // for that flush (redis_round_end arms it)
      if (want_close) h->close_pending = true;
      if (!out.empty()) batch_out->append(out.data(), out.size());
      return;
    }
    if (out.empty()) return;
    // py pthread, no round in flight: write under the lock so two py
    // responders draining consecutive seqs keep queue order
    IOBuf buf;
    buf.append(out.data(), out.size());
    s->write(std::move(buf));
    if (want_close) redis_arm_close(s);
  }
}

// -- the native store (DictRedisService semantics, redis.h:173) ------------

static bool ieq(std::string_view a, const char* b) {
  size_t n = strlen(b);
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; i++) {
    if (tolower((unsigned char)a[i]) != b[i]) return false;
  }
  return true;
}

// Execute a command against the native store. Returns false when the
// command is not natively handled (py lane takes it).
// The command words store_execute handles (everything else returns
// false and falls through to the py lane / the unknown-command error).
static bool store_command_known(std::string_view cmd) {
  static const char* kStoreCmds[] = {
      "ping", "echo",  "command", "select",   "set",     "get",
      "del",  "unlink", "exists", "incr",     "decr",    "incrby",
      "decrby", "append", "strlen", "mget",   "mset",    "dbsize",
      "flushall", "flushdb",
  };
  for (const char* k : kStoreCmds) {
    if (ieq(cmd, k)) return true;
  }
  return false;
}

static bool store_execute(RedisStoreN* st,
                          const std::vector<std::string>& argv,
                          std::string* out, bool known) {
  std::string_view cmd(argv[0]);
  // kStoreCmds is authoritative: `known` is the caller's (sole)
  // store_command_known(argv[0]) result, so a dispatch branch added
  // below without a list entry is refused here (the command loudly
  // falls through to the py lane) instead of silently recording no
  // per-method row
  if (!known) return false;
  size_t nargs = argv.size() - 1;
  if (ieq(cmd, "ping")) {
    if (nargs == 1) {
      r_bulk(out, argv[1]);
    } else {
      r_status(out, "PONG");
    }
    return true;
  }
  if (ieq(cmd, "echo")) {
    if (nargs != 1) {
      r_error(out, "ERR wrong number of arguments for 'echo' command");
    } else {
      r_bulk(out, argv[1]);
    }
    return true;
  }
  if (ieq(cmd, "command")) {
    out->append("*0\r\n");
    return true;
  }
  if (ieq(cmd, "select")) {
    r_status(out, "OK");
    return true;
  }
  if (ieq(cmd, "set")) {
    // plain SET k v only; SET with options (EX/NX/...) goes to py
    if (nargs != 2) return false;
    {
      std::lock_guard g(st->store_mu);
      st->kv[argv[1]] = argv[2];
    }
    r_status(out, "OK");
    return true;
  }
  if (ieq(cmd, "get")) {
    if (nargs != 1) {
      r_error(out, "ERR wrong number of arguments for 'get' command");
      return true;
    }
    std::lock_guard g(st->store_mu);
    auto it = st->kv.find(argv[1]);
    if (it == st->kv.end()) {
      r_nil(out);
    } else {
      r_bulk(out, it->second);
    }
    return true;
  }
  if (ieq(cmd, "del") || ieq(cmd, "unlink")) {
    int64_t n = 0;
    std::lock_guard g(st->store_mu);
    for (size_t i = 1; i < argv.size(); i++) n += st->kv.erase(argv[i]);
    r_int(out, n);
    return true;
  }
  if (ieq(cmd, "exists")) {
    int64_t n = 0;
    std::lock_guard g(st->store_mu);
    for (size_t i = 1; i < argv.size(); i++) {
      n += st->kv.count(argv[i]) ? 1 : 0;
    }
    r_int(out, n);
    return true;
  }
  if (ieq(cmd, "incr") || ieq(cmd, "decr") || ieq(cmd, "incrby") ||
      ieq(cmd, "decrby")) {
    int64_t delta = 1;
    if (ieq(cmd, "incrby") || ieq(cmd, "decrby")) {
      if (nargs != 2) {
        r_error(out, "ERR wrong number of arguments");
        return true;
      }
      char* dend = nullptr;
      delta = strtoll(argv[2].c_str(), &dend, 10);
      if (argv[2].empty() || dend == nullptr || *dend != '\0') {
        r_error(out, "ERR value is not an integer or out of range");
        return true;
      }
    } else if (nargs != 1) {
      r_error(out, "ERR wrong number of arguments");
      return true;
    }
    if (ieq(cmd, "decr") || ieq(cmd, "decrby")) delta = -delta;
    std::lock_guard g(st->store_mu);
    std::string& v = st->kv[argv[1]];
    char* endp = nullptr;
    int64_t cur = v.empty() ? 0 : strtoll(v.c_str(), &endp, 10);
    if (!v.empty() && (endp == nullptr || *endp != '\0')) {
      r_error(out, "ERR value is not an integer or out of range");
      return true;
    }
    cur += delta;
    char buf[32];
    snprintf(buf, sizeof(buf), "%lld", (long long)cur);
    v = buf;
    r_int(out, cur);
    return true;
  }
  if (ieq(cmd, "append")) {
    if (nargs != 2) {
      r_error(out, "ERR wrong number of arguments");
      return true;
    }
    std::lock_guard g(st->store_mu);
    std::string& v = st->kv[argv[1]];
    v += argv[2];
    r_int(out, (int64_t)v.size());
    return true;
  }
  if (ieq(cmd, "strlen")) {
    if (nargs != 1) {
      r_error(out, "ERR wrong number of arguments");
      return true;
    }
    std::lock_guard g(st->store_mu);
    auto it = st->kv.find(argv[1]);
    r_int(out, it == st->kv.end() ? 0 : (int64_t)it->second.size());
    return true;
  }
  if (ieq(cmd, "mset")) {
    if (nargs == 0 || nargs % 2 != 0) {
      r_error(out, "ERR wrong number of arguments for 'mset' command");
      return true;
    }
    std::lock_guard g(st->store_mu);
    for (size_t i = 1; i + 1 < argv.size(); i += 2) {
      st->kv[argv[i]] = argv[i + 1];
    }
    r_status(out, "OK");
    return true;
  }
  if (ieq(cmd, "mget")) {
    char buf[32];
    snprintf(buf, sizeof(buf), "*%zu\r\n", nargs);
    out->append(buf);
    std::lock_guard g(st->store_mu);
    for (size_t i = 1; i < argv.size(); i++) {
      auto it = st->kv.find(argv[i]);
      if (it == st->kv.end()) {
        r_nil(out);
      } else {
        r_bulk(out, it->second);
      }
    }
    return true;
  }
  if (ieq(cmd, "dbsize")) {
    std::lock_guard g(st->store_mu);
    r_int(out, (int64_t)st->kv.size());
    return true;
  }
  if (ieq(cmd, "flushdb") || ieq(cmd, "flushall")) {
    std::lock_guard g(st->store_mu);
    st->kv.clear();
    r_status(out, "OK");
    return true;
  }
  return false;  // unknown: the Python RedisService decides
}

// -- the cut loop -----------------------------------------------------------

int redis_sniff(const char* p, size_t n) {
  // RESP command arrays only ('*'); inline commands stay on the raw
  // fallback lane (they cannot be confused with any other protocol here)
  return n >= 1 && p[0] == '*' ? 1 : 0;
}

// Parse + dispatch every complete RESP command in s->in_buf.
// 1 = session active, 0 = protocol error.
int redis_try_process(NatSocket* s, IOBuf* batch_out) {
  NatServer* srv = s->server;
  if (s->redis == nullptr) {
    char pfx[1];
    if (s->in_buf.empty()) return 0;
    s->in_buf.copy_to(pfx, 1);
    if (redis_sniff(pfx, 1) == 0) return 0;
    if (srv == nullptr || srv->native_redis == 0) return 0;
    s->redis = new RedisSessN();
  }
  RedisSessN* h = s->redis;
  {
    std::lock_guard g(h->redis_mu);
    h->round_active = true;
  }
  int rc = 1;
  size_t buffered = s->in_buf.length();
  // A known-incomplete big command: skip re-copying the whole buffer
  // every read burst until enough bytes arrived.
  if (buffered == 0 || buffered < h->need_bytes) return rc;
  h->need_bytes = 0;
  // ONE contiguous copy per round; commands parse at an offset and the
  // consumed prefix pops once at the end (burst parsing stays O(n)).
  size_t scan_len = buffered < kMaxRedisCommandBytes + 4096
                        ? buffered
                        : kMaxRedisCommandBytes + 4096;
  std::string heap;
  heap.resize(scan_len);
  s->in_buf.copy_to(&heap[0], scan_len);
  const char* base = heap.data();
  size_t consumed = 0;

  while (consumed < scan_len && rc == 1) {
    const char* p = base + consumed;
    size_t avail = scan_len - consumed;
    if (p[0] != '*') {
      rc = 0;  // mid-stream garbage
      break;
    }
    // *N\r\n
    const char* nl = (const char*)memchr(p, '\n', avail);
    if (nl == nullptr) {
      if (avail > 64) rc = 0;  // an argc line this long is garbage
      break;
    }
    char* endp = nullptr;
    long nargs = NAT_WIRE(strtol(p + 1, &endp, 10));
    if (endp == nullptr || *endp != '\r' || nargs <= 0 ||
        (size_t)nargs > kMaxRedisArgs) {
      rc = 0;
      break;
    }
    size_t pos = (size_t)(nl - p) + 1;
    std::vector<std::string> argv;
    // cap by what the buffered bytes could possibly hold ("$0\r\n\r\n" is
    // 4+ bytes/arg): a 14-byte "*1048576\r\n$1\r\nx" must not force a
    // ~32MB reservation every parse round (ADVICE r5)
    size_t max_plausible = avail / 4;
    argv.reserve((size_t)nargs < max_plausible ? (size_t)nargs
                                               : max_plausible);
    bool complete = true;
    size_t need = 0;  // known minimum total size of this command
    for (long i = 0; i < nargs; i++) {
      if (pos >= avail) {
        complete = false;
        break;
      }
      if (p[pos] != '$') {
        rc = 0;
        break;
      }
      const char* anl = (const char*)memchr(p + pos, '\n', avail - pos);
      if (anl == nullptr) {
        complete = false;
        break;
      }
      char* aend = nullptr;
      long alen = NAT_WIRE(strtol(p + pos + 1, &aend, 10));
      if (aend == nullptr || *aend != '\r' || alen < 0 ||
          (size_t)alen > kMaxRedisCommandBytes) {
        rc = 0;
        break;
      }
      size_t data_off = (size_t)(anl - p) + 1;
      if (data_off + (size_t)alen + 2 > avail) {
        complete = false;
        need = data_off + (size_t)alen + 2;
        break;
      }
      argv.emplace_back(p + data_off, (size_t)alen);
      pos = data_off + (size_t)alen + 2;
    }
    if (rc == 0) break;
    if (!complete) {
      if (need > kMaxRedisCommandBytes) {
        rc = 0;  // a command past the cap can never complete
      } else if (need > 0) {
        // wait copy-free until the whole command is buffered
        h->need_bytes = consumed + need;
      }
      break;
    }
    consumed += pos;
    srv->requests.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_REDIS_MSGS_IN, 1);
    s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
    uint64_t seq =
        h->next_req_seq.fetch_add(1, std::memory_order_relaxed);

    // QUIT: +OK, then close once that reply has drained to the socket
    if (ieq(argv[0], "quit")) {
      {
        std::lock_guard g(h->redis_mu);
        h->close_after_seq = seq;
      }
      std::string ok;
      r_status(&ok, "OK");
      redis_emit(s, h, seq, std::move(ok), batch_out);
      continue;
    }
    if (srv->native_redis == 2 && srv->redis_store != nullptr) {
      std::string reply;
      uint64_t t_parse = nat_now_ns();  // command cut, about to execute
      // per-method row keyed by the command name ("SET"/"GET"/...) —
      // only store-family commands claim one: argv[0] is raw wire bytes,
      // and unknown words must not burn never-freed table slots. The
      // key is case-normalized to match store_command_known's ieq():
      // "set"/"SET"/"sEt" must share ONE row, not claim a never-freed
      // slot per case variant.
      const bool store_known = store_command_known(argv[0]);
      int midx = -1;
      if (store_known) {
        char word[16];  // fits every kStoreCmds word ("flushall" is
                        // the longest at 8); names >= 16 would truncate
                        // to a different key than store_command_known
                        // matched, so grow this with the list
        size_t wl = argv[0].size() < sizeof(word) ? argv[0].size()
                                                  : sizeof(word) - 1;
        for (size_t wi = 0; wi < wl; wi++) {
          char ch = argv[0][wi];
          word[wi] = (ch >= 'a' && ch <= 'z') ? (char)(ch - 32) : ch;
        }
        midx = nat_method_idx(NL_REDIS, word, wl);
        // flight-recorder tap (redis store seam): the raw RESP command
        // bytes (p..pos), method = the case-normalized command word;
        // RESP carries no trace metadata, so the ids stay 0
        if (nat_dump_enabled() && nat_dump_tick()) {
          nat_dump_sample(NL_REDIS, "", 0, word, wl, nullptr, 0, p, pos,
                          0, 0);
        }
      }
      nat_method_begin(midx);
      if (store_execute(srv->redis_store, argv, &reply, store_known)) {
        uint64_t t_dispatch = nat_now_ns();
        uint32_t req_b = (uint32_t)pos;
        uint32_t resp_b = (uint32_t)reply.size();
        bool is_err = !reply.empty() && reply[0] == '-';
        redis_emit(s, h, seq, std::move(reply), batch_out);
        uint64_t t_write = nat_now_ns();
        nat_lat_record(NL_REDIS, t_write - t_parse);
        nat_method_end(midx, t_write - t_parse, is_err);
        if (nat_span_tick()) {
          nat_span_record(NL_REDIS, s->id, argv[0].data(), argv[0].size(),
                          t_parse, t_parse, t_dispatch, t_write,
                          is_err ? 1 : 0, req_b, resp_b);
        }
        continue;
      }
      // not a store-family command: no completion recorded here — the
      // py lane (or the error reply below) owns it
      nat_method_abort(midx);
    }
    if (!srv->py_lane_enabled) {
      std::string err;
      r_error(&err, "ERR unknown command");
      redis_emit(s, h, seq, std::move(err), batch_out);
      continue;
    }
    // py lane (kind 6): argv packed as count + (len,bytes)*
    PyRequest* r = new PyRequest();
    r->kind = 6;
    r->sock_id = s->id;
    r->cid = (int64_t)seq;
    std::string& pk = r->payload;
    char buf[4];
    wr_be32(buf, (uint32_t)argv.size());
    pk.append(buf, 4);
    for (const std::string& a : argv) {
      wr_be32(buf, (uint32_t)a.size());
      pk.append(buf, 4);
      pk.append(a);
    }
    srv->enqueue_py(r);
  }
  if (consumed > 0) s->in_buf.pop_front(consumed);
  if (h->need_bytes > consumed) {
    h->need_bytes -= consumed;
  } else {
    h->need_bytes = 0;
  }
  return rc;
}

// End of a read round, called AFTER the round's batch accumulator has
// been flushed to the write queue: drain replies py responders parked
// while the round was active (parking while a round holds unflushed
// earlier replies is what keeps the wire in command order), then let
// direct py writes through again.
void redis_round_end(NatSocket* s) {
  RedisSessN* h = s->redis;
  if (h == nullptr) return;
  std::string out;
  bool want_close = false;
  std::lock_guard g(h->redis_mu);
  redis_drain_locked(s, h, &out, &want_close);
  want_close = want_close || h->close_pending;
  h->close_pending = false;
  h->round_active = false;
  if (!out.empty()) {
    IOBuf f;
    f.append(out.data(), out.size());
    s->write(std::move(f));  // under h->redis_mu: ordered vs py emitters
  }
  if (want_close) redis_arm_close(s);
}

extern "C" {

// Python lane answer for a kind-6 request: `data` is the complete RESP
// reply. Ordering is enforced by the native reorder window.
int nat_redis_respond(uint64_t sock_id, int64_t seq, const char* data,
                      size_t len) {
  NatSocket* s = sock_address(sock_id);
  if (s == nullptr) return -1;
  RedisSessN* h = s->redis;
  if (h == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    return -1;
  }
  redis_emit(s, h, (uint64_t)seq, std::string(data, len), nullptr);
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

}  // extern "C"

}  // namespace brpc_tpu
