// nat_cluster — the native fan-out core (ROADMAP item 1): a C++ cluster
// object holding the DoublyBufferedData server list (nat_lb.{h,cpp}),
// per-backend lazily-dialed NatChannels with the PR-5 circuit breakers
// and PR-8 lame-duck detach, a naming-observer feed (nat_cluster_update
// carries the FULL resolved list each refresh, so every Python naming
// scheme — list/file/dns/consul/discovery/nacos/remotefile — drives it
// day one), and the combo-channel verbs at C++ speed:
//
//   nat_cluster_call            SelectiveChannel: LB-pick one backend,
//                               failover-retry on another (exclusion set)
//   nat_cluster_parallel_call   ParallelChannel: fan the same request to
//                               every backend concurrently, merge
//                               responses natively (fail_limit preserved)
//   nat_cluster_partition_call  PartitionChannel: one sub-call per
//                               partition group (server tag "i/n")
//
// The native merge is byte concatenation of the successful sub-responses
// in backend/partition order — for serialized protobuf messages that IS
// MergeFrom (protobuf wire format: concatenation == merge), so the
// Python fast path parses the concatenated bytes into the caller's
// response and gets ResponseMerger-default semantics for free.
//
// Sub-calls ride the normal NatChannel machinery (begin_call slots, the
// wait-free socket write stack, per-call deadlines, messenger-side
// breaker verdicts); backends that need a dial get their sub-call issued
// from a scheduler fiber so a dead peer's connect timeout never
// serializes the whole fan-out. Per-sub-call client spans parent under
// one trace (PR-6 stitching): every sub-call carries the same trace_id
// with the fan-out verb's span as parent, and the verb submits its own
// span over the full fan/merge window.
#include "nat_internal.h"
#include "nat_lb.h"

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// backend lifecycle
// ---------------------------------------------------------------------------

// Lazily-connected channel: peer recorded, no dial — channel_socket
// dials on first use (the Channel reuse-after-failure arm doubles as
// the initial dial). The cluster enables the breaker per backend so one
// dead peer isolates itself instead of eating retries.
static NatChannel* channel_create_lazy(const char* ip, int port,
                                       int connect_timeout_ms,
                                       int health_check_ms, bool breaker) {
  // natcheck:allow(resacct): NatChannel self-accounts in its ctor/dtor
  NatChannel* ch = new NatChannel();
  NAT_REF_ACQUIRED(ch, chan.opener);  // released by nat_channel_close
  ch->peer_ip = ip;
  ch->peer_port = port;
  ch->connect_timeout_ms = connect_timeout_ms;
  ch->health_check_interval_ms = health_check_ms;
  if (breaker) {
    ch->breaker_enabled.store(true, std::memory_order_release);
  }
  return ch;
}

void NatLbBackend::release() {
  if (ref.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    NAT_REF_DEAD(this);  // refguard: clus.* tags balanced before delete
    if (ch != nullptr) nat_channel_close(ch);
    NAT_RES_FREE(NR_CLUSTER, sizeof(NatLbBackend), this);
    delete this;
  }
}

bool nat_lb_backend_usable(const NatLbBackend* b) {
  if (b->removed.load(std::memory_order_relaxed)) return false;
  NatChannel* ch = b->ch;
  if (ch == nullptr || ch->closed.load(std::memory_order_acquire)) {
    return false;
  }
  // breaker-isolated peers stay out of the candidate set until the
  // health-check chain revives them (selection-level fail-fast; the
  // channel's own fail-fast still guards the race window)
  if (ch->breaker_enabled.load(std::memory_order_relaxed) &&
      ch->breaker_broken.load(std::memory_order_acquire)) {
    return false;
  }
  int64_t now_ms = (int64_t)(nat_now_ns() / 1000000ull);
  // transport-failure cool-down (nat_lb.h: refused dials never feed
  // the breaker, and a dead server's backends sort CONTIGUOUS — the
  // rr retry walk needs them out of the candidate set)
  if (b->cool_until_ms.load(std::memory_order_relaxed) > now_ms) {
    return false;
  }
  // freshly lame-ducked peer whose replacement socket hasn't dialed
  // yet: let the restart window pass instead of re-dialing into the
  // FIN (selection re-balances; the shadow is short so a restarted
  // peer rejoins quickly)
  int64_t ld = ch->lame_duck_ms.load(std::memory_order_relaxed);
  if (ld != 0 &&
      ch->sock_id.load(std::memory_order_acquire) == 0 &&
      now_ms - ld < 300) {
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// NatCluster
// ---------------------------------------------------------------------------

struct NatCluster {
  int policy = NAT_LB_RR;
  int connect_timeout_ms = 0;
  int health_check_ms = 0;
  bool breaker = true;
  // control plane (naming updates, close, stats walk): ranks below the
  // runtime lock so membership changes may create channels while held
  NatMutex<kLockRankCluster> cluster_mu;
  std::map<std::string, NatLbBackend*> members;  // under mu (clus.member)
  std::atomic<ServerListVer*> cur{nullptr};
  LbGate gate;
  std::atomic<uint64_t> cursor{0};  // rr/wrr shared cursor
  std::atomic<bool> closed{false};

  std::atomic<int> ref{1};
  void add_ref() { ref.fetch_add(1, std::memory_order_relaxed); }
  void release() {
    if (ref.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      NAT_REF_DEAD(this);
      ServerListVer* v = cur.load(std::memory_order_acquire);
      if (v != nullptr) {
        for (NatLbBackend* b : v->backends) {
          NAT_REF_RELEASE(b, clus.ver);
        }
        delete v;
      }
      NAT_RES_FREE(NR_CLUSTER, sizeof(NatCluster), this);
      delete this;
    }
  }
};

// Pin the cluster for one verb/control operation; verbs run without the
// mutex, so the pin is what keeps the gate/version machinery alive if
// the embedder races a close (the close itself only detaches members).
static NatCluster* cluster_pin(void* h) {
  NatCluster* c = (NatCluster*)h;
  if (c == nullptr) return nullptr;
  // pin first, then check: a close racing this pin still sees the ref
  // (the embedder contract — like nat_channel_close — is that close is
  // not issued while a verb is being STARTED on another thread; the
  // pin-then-check only narrows the benign half of that window)
  NAT_REF_ACQUIRE(c, clus.verb);
  if (c->closed.load(std::memory_order_acquire)) {
    NAT_REF_RELEASE(c, clus.verb);
    return nullptr;
  }
  return c;
}

// ---------------------------------------------------------------------------
// server-list parsing + the naming feed
// ---------------------------------------------------------------------------

struct ParsedNode {
  std::string ip;
  int port = 0;
  int weight = 1;
  std::string tag;
};

// "ip:port[ weight[ tag]]" entries separated by ';', ',' or newlines —
// the Python NamingService observer formats its (endpoint, weight, tag)
// node list this way; a bare integer second token is a weight (the
// list:// grammar), anything else is the tag.
static bool parse_server_spec(const char* spec,
                              std::vector<ParsedNode>* out) {
  if (spec == nullptr) return true;
  const char* p = spec;
  while (*p != '\0') {
    while (*p == ';' || *p == ',' || *p == '\n' || *p == ' ') p++;
    if (*p == '\0') break;
    const char* end = p;
    while (*end != '\0' && *end != ';' && *end != ',' && *end != '\n') {
      end++;
    }
    std::string entry(p, (size_t)(end - p));
    p = end;
    // split on spaces: endpoint [weight-or-tag [tag]]
    ParsedNode node;
    size_t sp = entry.find(' ');
    std::string ep = entry.substr(0, sp);
    size_t colon = ep.rfind(':');
    if (colon == std::string::npos || colon == 0) return false;
    node.ip = ep.substr(0, colon);
    node.port = atoi(ep.c_str() + colon + 1);
    if (node.port <= 0 || node.port > 65535 ||
        node.ip.size() >= sizeof(NatLbBackend::ip)) {
      return false;
    }
    while (sp != std::string::npos) {
      size_t start = entry.find_first_not_of(' ', sp);
      if (start == std::string::npos) break;
      sp = entry.find(' ', start);
      std::string tok = entry.substr(start, sp == std::string::npos
                                                ? std::string::npos
                                                : sp - start);
      bool digits = !tok.empty();
      for (char ch : tok) {
        if (ch < '0' || ch > '9') {
          digits = false;
          break;
        }
      }
      if (digits && node.tag.empty() && node.weight == 1) {
        node.weight = atoi(tok.c_str());
        if (node.weight < 1) node.weight = 1;
      } else if (node.tag.empty()) {
        node.tag = tok;
      }
    }
    out->push_back(std::move(node));
  }
  return true;
}

// "i/n" partition tag (PartitionParser's default grammar).
static void parse_partition_tag(NatLbBackend* b) {
  const char* slash = strchr(b->tag, '/');
  if (slash == nullptr || slash == b->tag) return;
  int idx = atoi(b->tag);
  int total = atoi(slash + 1);
  if (total > 0 && idx >= 0 && idx < total) {
    b->part_idx = idx;
    b->part_total = total;
  }
}

// True when two versions carry a different partition-scheme layout:
// a scheme appeared/vanished or any group's membership count changed.
// This is the dynpart-visible shape — a weight-only refresh publishes
// a new version without being a resize.
static bool parts_layout_differs(const ServerListVer* a,
                                 const ServerListVer* b) {
  if (a->parts.size() != b->parts.size()) return true;
  auto ia = a->parts.begin();
  auto ib = b->parts.begin();
  for (; ia != a->parts.end(); ++ia, ++ib) {
    if (ia->first != ib->first) return true;
    if (ia->second.size() != ib->second.size()) return true;
    for (size_t g = 0; g < ia->second.size(); g++) {
      if (ia->second[g].size() != ib->second[g].size()) return true;
    }
  }
  return false;
}

// Swap in a freshly-built version over the CURRENT member set. Caller
// holds c->mu (updates are serialized — the gate's parity quiesce is
// single-writer). Old version's backend references retire after the
// readers drain — an in-flight dynpart/partition fan keeps its pinned
// version's backends alive through clus.call references, so a resize
// published here is never visible to a call already issued.
static void cluster_publish_locked(NatCluster* c) {
  std::vector<NatLbBackend*> mem;
  mem.reserve(c->members.size());
  for (auto& kv : c->members) mem.push_back(kv.second);
  ServerListVer* nv =
      nat_lb_build_version(mem.data(), (int)mem.size(), c->policy);
  for (NatLbBackend* b : nv->backends) {
    NAT_REF_ACQUIRE(b, clus.ver);
  }
  ServerListVer* old = c->cur.exchange(nv, std::memory_order_seq_cst);
  if (old != nullptr && parts_layout_differs(old, nv)) {
    nat_counter_add(NS_DYNPART_RESIZES, 1);
  }
  c->gate.quiesce();  // every reader of `old` has exited
  if (old != nullptr) {
    for (NatLbBackend* b : old->backends) {
      NAT_REF_RELEASE(b, clus.ver);
    }
    delete old;
  }
}

// ---------------------------------------------------------------------------
// fan-out machinery
// ---------------------------------------------------------------------------

struct FanCtx;

struct FanSub {
  FanCtx* ctx = nullptr;
  NatLbBackend* b = nullptr;  // clus.call reference (issuer inherits)
  int32_t err = 0;
  std::string err_text;
  std::string resp;
  uint64_t start_ns = 0;
};

struct FanCtx {
  std::atomic<int> pending{0};
  Butex done;  // 0 = in flight, 1 = all sub-calls complete
  // set AFTER the final butex_wake returns: the caller must not free
  // this (stack-owned) context while the waker is still inside
  // butex_wake's lock-free nwaiters probe — the Fiber::join_wake_done
  // discipline applied to the fan-out completion
  std::atomic<uint32_t> wake_done{0};
  const char* service = nullptr;
  const char* method = nullptr;
  const char* payload = nullptr;
  size_t payload_len = 0;
  int timeout_ms = 0;
  NatCallTrace parent;  // the verb's own span; sub-calls parent under it
  std::vector<FanSub> subs;
};

// Derive one sub-call's trace from the fan-out verb's span: same trace,
// fresh span id, parented under the verb (rpcz shows the verb with N
// child client spans — the ParallelChannel sub-call tree).
static NatCallTrace fan_child_trace(const FanCtx* ctx) {
  NatCallTrace tr;
  tr.sampled = ctx->parent.sampled;
  if (ctx->parent.trace_id != 0) {
    tr.trace_id = ctx->parent.trace_id;
    tr.span_id = nat_span_id63();
    tr.parent_span_id = ctx->parent.span_id;
  }
  tr.set_label(ctx->service, ".", ctx->method);
  return tr;
}

// Final accounting for one sub-call: LB feedback, backend release, then
// the pending decrement. ORDER MATTERS: after the decrement that drops
// pending to zero the caller may free the context, so the sub/backend
// must not be touched past fan_sub_finish.
static void fan_sub_finish(FanSub* sub) {
  FanCtx* ctx = sub->ctx;
  if (ctx->pending.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    ctx->done.value.store(1, std::memory_order_release);
    Scheduler::butex_wake(&ctx->done, INT32_MAX);
    ctx->wake_done.store(1, std::memory_order_release);
  }
}

static void fan_account_and_finish(FanSub* sub) {
  NatLbBackend* b = sub->b;
  uint64_t lat_us = sub->start_ns != 0
                        ? (nat_now_ns() - sub->start_ns) / 1000ull
                        : 0;
  nat_lb_feedback(b, sub->err == 0, lat_us);
  if (sub->err == 0) {
    nat_lb_note_ok(b);
  } else {
    if (sub->err == kEFAILEDSOCKET || sub->err == kERPCTIMEDOUT) {
      nat_lb_note_transport_failure(b);
    }
    nat_counter_add(NS_FANOUT_SUBCALL_ERRORS, 1);
  }
  b->inflight.fetch_sub(1, std::memory_order_relaxed);
  NAT_REF_RELEASE(b, clus.call);
  fan_sub_finish(sub);  // last touch: the context may die right after
}

// PendingCall completion (messenger thread / timeout fiber / fail_all):
// copy the result out, retire the slot, account.
static void fan_pc_complete(PendingCall* pc, void* raw) {
  FanSub* sub = (FanSub*)raw;
  sub->err = pc->error_code;
  if (pc->error_code == 0) {
    if (pc->inline_len > 0) {
      sub->resp.assign(pc->inline_resp, pc->inline_len);
    } else {
      sub->resp = pc->response.to_string();
    }
  } else {
    sub->err_text = pc->error_text;
  }
  pc_free(pc);
  fan_account_and_finish(sub);
}

// Issue one sub-call on its backend's channel. Runs inline on the
// caller thread when the channel already has a live socket (the write
// is a wait-free push), or on a scheduler fiber when a dial is needed
// (a dead backend's connect timeout must not serialize the fan-out —
// the health_check_dial_fiber precedent).
static void fan_issue(FanSub* sub) {
  NatChannel* ch = sub->b->ch;
  sub->start_ns = nat_now_ns();
  nat_counter_add(NS_FANOUT_SUBCALLS, 1);
  NatSocket* s = channel_socket(ch, sub->ctx->timeout_ms);
  if (s == nullptr) {
    sub->err = kEFAILEDSOCKET;
    sub->err_text = "backend unreachable";
    fan_account_and_finish(sub);
    return;
  }
  NatCallTrace tr = fan_child_trace(sub->ctx);
  int64_t cid = 0;
  PendingCall* pc = ch->begin_call(&cid, fan_pc_complete, sub, &tr);
  if (pc == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    sub->err = kEFAILEDSOCKET;
    sub->err_text = "call slots exhausted";
    fan_account_and_finish(sub);
    return;
  }
  if (sub->ctx->timeout_ms > 0) {
    arm_call_timeout(ch, cid, sub->ctx->timeout_ms);
  }
  IOBuf frame;
  build_request_frame(&frame, cid, sub->ctx->service, sub->ctx->method,
                      sub->ctx->payload, sub->ctx->payload_len, nullptr, 0,
                      tr.trace_id, tr.span_id);
  if (s->write(std::move(frame)) == 0) {
    s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  } else {
    PendingCall* mine = ch->take_pending(cid, /*ok=*/false);
    if (mine != nullptr) {
      mine->error_code = kEFAILEDSOCKET;
      mine->error_text = "socket failed before write";
      fan_pc_complete(mine, sub);  // ONE completion path (acall shape)
    }
    // else: fail_all already completed through fan_pc_complete
  }
  NAT_REF_RELEASE(s, sock.borrow);
}

static void fan_issue_fiber(void* raw) { fan_issue((FanSub*)raw); }

// Wait for every sub-call, then spin out the waker handshake (see
// FanCtx::wake_done). Called from the embedder's thread.
static void fan_wait(FanCtx* ctx) {
  while (ctx->done.value.load(std::memory_order_acquire) == 0) {
    Scheduler::butex_wait(&ctx->done, 0);
  }
  while (ctx->wake_done.load(std::memory_order_acquire) == 0) {
    sched_yield();
  }
}

// Merge the sub-results per the fail_limit contract. Returns the RPC rc;
// fills the out buffers (concat of SUCCESSFUL responses in sub order —
// protobuf concatenation == MergeFrom).
static int fan_merge(FanCtx* ctx, int fail_limit, char** resp_out,
                     size_t* resp_len, char** err_text_out,
                     int* failed_out) {
  int n = (int)ctx->subs.size();
  int failed = 0;
  int32_t first_err = 0;
  const std::string* first_text = nullptr;
  size_t total = 0;
  for (const FanSub& sub : ctx->subs) {
    if (sub.err != 0) {
      failed++;
      if (first_err == 0) {
        first_err = sub.err;
        first_text = &sub.err_text;
      }
    } else {
      total += sub.resp.size();
    }
  }
  if (failed_out != nullptr) *failed_out = failed;
  int limit = fail_limit > 0 && fail_limit < n ? fail_limit : n;
  if (failed >= limit) {
    nat_counter_add(NS_FANOUT_FAILS, 1);
    if (err_text_out != nullptr) {
      char buf[192];
      // snprintf returns the WOULD-BE length: clamp to what the buffer
      // actually holds before copying (a long server error text must
      // truncate, not read past the stack buffer)
      int k = snprintf(buf, sizeof(buf),
                       "%d/%d sub calls failed, first: [%d] %s", failed, n,
                       first_err,
                       first_text != nullptr ? first_text->c_str() : "");
      if (k < 0) k = 0;
      if (k >= (int)sizeof(buf)) k = (int)sizeof(buf) - 1;
      // natcheck:allow(resacct): FFI error text, freed by the caller
      *err_text_out = (char*)malloc((size_t)k + 1);
      memcpy(*err_text_out, buf, (size_t)k);
      (*err_text_out)[k] = '\0';
    }
    return kETOOMANYFAILS;
  }
  if (resp_out != nullptr) {
    // natcheck:allow(resacct): FFI merged response, freed by the caller
    char* out = (char*)malloc(total ? total : 1);
    size_t off = 0;
    for (const FanSub& sub : ctx->subs) {
      if (sub.err == 0 && !sub.resp.empty()) {
        memcpy(out + off, sub.resp.data(), sub.resp.size());
        off += sub.resp.size();
      }
    }
    *resp_out = out;
    *resp_len = total;
  }
  return 0;
}

// Submit the fan-out verb's own span (the parent of every sub-call span)
// covering the full fan/merge window.
static void fan_submit_parent_span(const FanCtx* ctx, const char* verb,
                                   uint64_t begin_ns, int rc) {
  if (!ctx->parent.sampled) return;
  NatSpanRec rec;
  memset(&rec, 0, sizeof(rec));
  rec.trace_id = ctx->parent.trace_id;
  rec.span_id = ctx->parent.span_id;
  rec.parent_span_id = ctx->parent.parent_span_id;
  rec.recv_ns = begin_ns;
  rec.parse_ns = begin_ns;
  rec.dispatch_ns = nat_now_ns();
  rec.write_ns = rec.dispatch_ns;
  rec.protocol = NL_CLIENT;
  rec.error_code = rc;
  snprintf(rec.method, sizeof(rec.method), "%s*%zu", verb,
           ctx->subs.size());
  nat_span_submit(rec);
}

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void* nat_cluster_create(const char* lb_policy, int connect_timeout_ms,
                         int health_check_ms, int enable_breaker) {
  int policy = nat_lb_policy_parse(lb_policy);
  if (policy < 0) return nullptr;
  if (ensure_runtime(0) != 0) return nullptr;
  NatCluster* c = new NatCluster();
  NAT_RES_ALLOC(NR_CLUSTER, sizeof(NatCluster), c);
  NAT_REF_ACQUIRED(c, clus.opener);  // released by nat_cluster_close
  c->policy = policy;
  c->connect_timeout_ms = connect_timeout_ms;
  c->health_check_ms = health_check_ms;
  c->breaker = enable_breaker != 0;
  {
    std::lock_guard g(c->cluster_mu);
    cluster_publish_locked(c);  // empty version: verbs never see null
  }
  return c;
}

void nat_cluster_close(void* h) {
  NatCluster* c = (NatCluster*)h;
  if (c == nullptr) return;
  c->closed.store(true, std::memory_order_release);
  {
    std::lock_guard g(c->cluster_mu);
    for (auto& kv : c->members) {
      kv.second->removed.store(true, std::memory_order_relaxed);
      NAT_REF_RELEASE(kv.second, clus.member);
    }
    c->members.clear();
  }
  // the current version (and its backend references) retires with the
  // last verb's cluster pin
  NAT_REF_RELEASE(c, clus.opener);
}

// Full-list naming feed: diff against the member map — additions open a
// lazily-dialed channel, removals retire once every version/in-flight
// reference drains — then swap in a freshly-built version. Returns the
// backend count, or -1 on a malformed spec / closed cluster.
int nat_cluster_update(void* h, const char* servers) {
  NatCluster* c = cluster_pin(h);
  if (c == nullptr) return -1;
  std::vector<ParsedNode> nodes;
  if (!parse_server_spec(servers, &nodes)) {
    NAT_REF_RELEASE(c, clus.verb);
    return -1;
  }
  int count;
  {
    std::lock_guard g(c->cluster_mu);
    std::map<std::string, const ParsedNode*> want;
    for (const ParsedNode& n : nodes) {
      char key[48];
      snprintf(key, sizeof(key), "%s:%d", n.ip.c_str(), n.port);
      want[key] = &n;  // duplicates collapse (last entry wins)
    }
    // removals first (a flapping endpoint re-adds below with a FRESH
    // channel instead of inheriting a breaker-broken one)
    for (auto it = c->members.begin(); it != c->members.end();) {
      if (want.find(it->first) == want.end()) {
        it->second->removed.store(true, std::memory_order_relaxed);
        nat_counter_add(NS_CLUSTER_BACKENDS_REMOVED, 1);
        NAT_REF_RELEASE(it->second, clus.member);
        it = c->members.erase(it);
      } else {
        ++it;
      }
    }
    for (auto& kv : want) {
      auto it = c->members.find(kv.first);
      if (it != c->members.end()) {
        // weight/tag may change in place: the next publish rebuilds
        // the derived structures from the live fields
        it->second->weight.store(
            kv.second->weight > 0 ? kv.second->weight : 1,
            std::memory_order_relaxed);
        snprintf(it->second->tag, sizeof(it->second->tag), "%s",
                 kv.second->tag.c_str());
        it->second->part_idx = -1;
        it->second->part_total = 0;
        parse_partition_tag(it->second);
        continue;
      }
      NatLbBackend* b = new NatLbBackend();
      NAT_RES_ALLOC(NR_CLUSTER, sizeof(NatLbBackend), b);
      NAT_REF_ACQUIRE(b, clus.member);  // removal (or close) releases
      snprintf(b->endpoint, sizeof(b->endpoint), "%s", kv.first.c_str());
      snprintf(b->ip, sizeof(b->ip), "%s", kv.second->ip.c_str());
      b->port = kv.second->port;
      b->weight.store(kv.second->weight > 0 ? kv.second->weight : 1,
                      std::memory_order_relaxed);
      snprintf(b->tag, sizeof(b->tag), "%s", kv.second->tag.c_str());
      parse_partition_tag(b);
      b->ch = channel_create_lazy(b->ip, b->port, c->connect_timeout_ms,
                                  c->health_check_ms, c->breaker);
      c->members[kv.first] = b;
      nat_counter_add(NS_CLUSTER_BACKENDS_ADDED, 1);
    }
    cluster_publish_locked(c);
    count = (int)c->members.size();
  }
  nat_counter_add(NS_CLUSTER_UPDATES, 1);
  NAT_REF_RELEASE(c, clus.verb);
  return count;
}

int nat_cluster_backend_count(void* h) {
  NatCluster* c = cluster_pin(h);
  if (c == nullptr) return -1;
  int n;
  {
    std::lock_guard g(c->cluster_mu);
    n = (int)c->members.size();
  }
  NAT_REF_RELEASE(c, clus.verb);
  return n;
}

// Lookup-only selection probe (tests + consoles): which endpoint would
// the LB pick for `request_code` right now? No channel use, no select
// counters — the consistent-hash remap property test keys on this.
int nat_cluster_select_debug(void* h, uint64_t request_code, char* ep_out,
                             size_t cap) {
  NatCluster* c = cluster_pin(h);
  if (c == nullptr) return -1;
  int rc = -1;
  int tok = c->gate.enter();
  const ServerListVer* v = c->cur.load(std::memory_order_seq_cst);
  int idx = nat_lb_select(v, c->policy, &c->cursor, request_code, nullptr,
                          0);
  if (idx >= 0 && ep_out != nullptr && cap > 0) {
    snprintf(ep_out, cap, "%s", v->backends[idx]->endpoint);
    rc = 0;
  }
  c->gate.exit(tok);
  NAT_REF_RELEASE(c, clus.verb);
  return rc;
}

// SelectiveChannel verb: LB-pick one backend, call it, fail over to
// another (excluding tried peers) while attempts and deadline remain.
// timeout_ms covers ALL attempts (reference semantics); request_code
// keys the consistent-hash policy.
int nat_cluster_call(void* h, const char* service, const char* method,
                     const char* payload, size_t payload_len,
                     int timeout_ms, int max_retry, uint64_t request_code,
                     char** resp_out, size_t* resp_len,
                     char** err_text_out) {
  NatCluster* c = cluster_pin(h);
  if (resp_out != nullptr) {
    *resp_out = nullptr;
    *resp_len = 0;
  }
  if (err_text_out != nullptr) *err_text_out = nullptr;
  if (c == nullptr) return kEFAILEDSOCKET;
  nat_counter_add(NS_FANOUT_CALLS, 1);
  uint64_t deadline_ns =
      timeout_ms > 0 ? nat_now_ns() + (uint64_t)timeout_ms * 1000000ull
                     : 0;
  // exclusion window: with rolling restarts taking a quarter of a big
  // swarm down at once, the zero-failed contract needs the failover to
  // keep avoiding peers it already burned an attempt on
  NatLbBackend* tried[16];
  int n_tried = 0;
  int attempt = 0;
  uint64_t churn_spins = 0;
  int rc = kEFAILEDSOCKET;
  while (true) {
    int remaining_ms = timeout_ms;
    if (deadline_ns != 0) {
      uint64_t now = nat_now_ns();
      if (now >= deadline_ns) {
        rc = kERPCTIMEDOUT;
        break;
      }
      remaining_ms = (int)((deadline_ns - now) / 1000000ull);
      if (remaining_ms < 1) remaining_ms = 1;
    }
    NatLbBackend* b = nullptr;
    {
      int tok = c->gate.enter();
      const ServerListVer* v = c->cur.load(std::memory_order_seq_cst);
      int idx = nat_lb_select(v, c->policy, &c->cursor, request_code,
                              tried, n_tried);
      if (idx >= 0) {
        b = v->backends[idx];
        NAT_REF_ACQUIRE(b, clus.call);
      }
      c->gate.exit(tok);
    }
    if (b == nullptr) {
      // nothing selectable right now (whole cluster lame-ducked /
      // cooled / isolated / empty): while the DEADLINE allows, wait a
      // beat and retry — rolling restarts and cool-down windows empty
      // the candidate set only briefly, and the deadline is the bound
      // the caller chose. Without a deadline, attempts bound it.
      if (deadline_ns == 0 && attempt++ >= max_retry) {
        rc = kEFAILEDSOCKET;
        if (err_text_out != nullptr && *err_text_out == nullptr) {
          const char* msg = "no usable backend";
          // natcheck:allow(resacct): FFI error text, freed by the caller
          *err_text_out = (char*)malloc(strlen(msg) + 1);
          memcpy(*err_text_out, msg, strlen(msg) + 1);
        }
        break;
      }
      struct timespec ts = {0, 10 * 1000 * 1000};
      nanosleep(&ts, nullptr);
      continue;
    }
    nat_counter_add(NS_LB_SELECTS, 1);
    b->selects.fetch_add(1, std::memory_order_relaxed);
    b->inflight.fetch_add(1, std::memory_order_relaxed);
    if (err_text_out != nullptr && *err_text_out != nullptr) {
      free(*err_text_out);  // superseded by this attempt
      *err_text_out = nullptr;
    }
    uint64_t t0 = nat_now_ns();
    rc = nat_channel_call_full(b->ch, service, method, payload,
                               payload_len, remaining_ms, 0, 0, resp_out,
                               resp_len, err_text_out);
    nat_lb_feedback(b, rc == 0, (nat_now_ns() - t0) / 1000ull);
    if (rc == 0) {
      nat_lb_note_ok(b);
    } else if (rc == kEFAILEDSOCKET || rc == kERPCTIMEDOUT) {
      nat_lb_note_transport_failure(b);
    }
    b->inflight.fetch_sub(1, std::memory_order_relaxed);
    if (rc == 0) {
      NAT_REF_RELEASE(b, clus.call);
      break;
    }
    if (n_tried < 16) tried[n_tried++] = b;
    NAT_REF_RELEASE(b, clus.call);
    // Planned-churn class (failed socket / drain-window ELIMIT): a
    // rolling restart must not surface as a caller-visible failure, so
    // while the DEADLINE remains these retry without consuming the
    // attempt budget (lightly paced — a fully-down cluster spins at
    // dial-refusal speed otherwise). The deadline is the real bound: a
    // selective call fails only when its time is spent or non-churn
    // errors exhaust max_retry.
    if ((rc == kEFAILEDSOCKET || rc == kELIMIT) && deadline_ns != 0) {
      if (++churn_spins % 8 == 0) {
        struct timespec ts = {0, 2 * 1000 * 1000};
        nanosleep(&ts, nullptr);
      }
      continue;
    }
    if (attempt++ >= max_retry) break;
  }
  NAT_REF_RELEASE(c, clus.verb);
  return rc;
}

// Shared tail of the parallel/partition verbs: issue every prepared
// sub (live-socket backends inline — the write is one wait-free push —
// dial-needed ones on fibers), wait, merge, span.
static int fan_run(NatCluster* c, FanCtx* ctx, const char* verb,
                   int fail_limit, char** resp_out, size_t* resp_len,
                   char** err_text_out, int* failed_out) {
  uint64_t begin_ns = nat_now_ns();
  nat_counter_add(NS_FANOUT_CALLS, 1);
  int n = (int)ctx->subs.size();
  if (n == 0) {
    // nothing to fan (callers normally catch this earlier): complete
    // the context directly — a zero-pending wait would never wake
    ctx->done.value.store(1, std::memory_order_release);
    ctx->wake_done.store(1, std::memory_order_release);
  }
  ctx->pending.store(n, std::memory_order_relaxed);
  for (int i = 0; i < n; i++) {
    FanSub* sub = &ctx->subs[i];
    if (sub->b == nullptr) {
      // prepared as failed (empty partition): account directly
      nat_counter_add(NS_FANOUT_SUBCALL_ERRORS, 1);
      fan_sub_finish(sub);
      continue;
    }
    nat_counter_add(NS_LB_SELECTS, 1);
    sub->b->selects.fetch_add(1, std::memory_order_relaxed);
    sub->b->inflight.fetch_add(1, std::memory_order_relaxed);
    if (sub->b->ch->sock_id.load(std::memory_order_acquire) != 0) {
      fan_issue(sub);
    } else {
      Scheduler::instance()->spawn_detached(fan_issue_fiber, sub);
    }
  }
  fan_wait(ctx);
  int rc = fan_merge(ctx, fail_limit, resp_out, resp_len, err_text_out,
                     failed_out);
  fan_submit_parent_span(ctx, verb, begin_ns, rc);
  NAT_REF_RELEASE(c, clus.verb);
  return rc;
}

// ParallelChannel verb: the same request fans to EVERY backend of the
// current server list; responses merge natively in backend order. The
// call fails once failed sub-calls reach fail_limit (<=0 = all).
int nat_cluster_parallel_call(void* h, const char* service,
                              const char* method, const char* payload,
                              size_t payload_len, int timeout_ms,
                              int fail_limit, char** resp_out,
                              size_t* resp_len, char** err_text_out,
                              int* failed_out) {
  NatCluster* c = cluster_pin(h);
  if (resp_out != nullptr) {
    *resp_out = nullptr;
    *resp_len = 0;
  }
  if (err_text_out != nullptr) *err_text_out = nullptr;
  if (failed_out != nullptr) *failed_out = 0;
  if (c == nullptr) return kEFAILEDSOCKET;
  FanCtx ctx;
  ctx.service = service;
  ctx.method = method;
  ctx.payload = payload;
  ctx.payload_len = payload_len;
  ctx.timeout_ms = timeout_ms;
  ctx.parent = nat_begin_call_trace();
  {
    int tok = c->gate.enter();
    const ServerListVer* v = c->cur.load(std::memory_order_seq_cst);
    ctx.subs.resize(v->backends.size());
    size_t k = 0;
    for (NatLbBackend* b : v->backends) {
      if (b->removed.load(std::memory_order_relaxed)) continue;
      ctx.subs[k].ctx = &ctx;
      ctx.subs[k].b = b;
      NAT_REF_ACQUIRE(b, clus.call);
      k++;
    }
    ctx.subs.resize(k);
    c->gate.exit(tok);
  }
  if (ctx.subs.empty()) {
    NAT_REF_RELEASE(c, clus.verb);
    if (err_text_out != nullptr) {
      const char* msg = "no sub channels";
      // natcheck:allow(resacct): FFI error text, freed by the caller
      *err_text_out = (char*)malloc(strlen(msg) + 1);
      memcpy(*err_text_out, msg, strlen(msg) + 1);
    }
    // natcheck:allow(refown-leak-path): zero subs collected on this arm
    // means the loop above acquired zero clus.call references
    return kETOOMANYFAILS;
  }
  // natcheck:allow(refown-leak-path): every collected sub's clus.call is
  // released by fan_run's issue/completion path (fan_account_and_finish)
  return fan_run(c, &ctx, "parallel", fail_limit, resp_out, resp_len,
                 err_text_out, failed_out);
}

// PartitionChannel verb: one sub-call per partition group — backends
// tagged "i/n" with n == `partitions` (0 = the largest scheme present).
// Within a group the member is rr-picked among usable backends; an
// EMPTY partition counts as a failed sub-call (a PartitionChannel's
// dead sub-channel, not a silently-shrunk response).
int nat_cluster_partition_call(void* h, const char* service,
                               const char* method, const char* payload,
                               size_t payload_len, int timeout_ms,
                               int partitions, int fail_limit,
                               char** resp_out, size_t* resp_len,
                               char** err_text_out, int* failed_out) {
  NatCluster* c = cluster_pin(h);
  if (resp_out != nullptr) {
    *resp_out = nullptr;
    *resp_len = 0;
  }
  if (err_text_out != nullptr) *err_text_out = nullptr;
  if (failed_out != nullptr) *failed_out = 0;
  if (c == nullptr) return kEFAILEDSOCKET;
  FanCtx ctx;
  ctx.service = service;
  ctx.method = method;
  ctx.payload = payload;
  ctx.payload_len = payload_len;
  ctx.timeout_ms = timeout_ms;
  ctx.parent = nat_begin_call_trace();
  int total = 0;
  {
    int tok = c->gate.enter();
    const ServerListVer* v = c->cur.load(std::memory_order_seq_cst);
    const std::vector<std::vector<uint32_t>>* groups = nullptr;
    if (partitions > 0) {
      auto it = v->parts.find(partitions);
      if (it != v->parts.end()) groups = &it->second;
      total = partitions;
    } else if (!v->parts.empty()) {
      auto it = std::prev(v->parts.end());  // largest scheme present
      groups = &it->second;
      total = it->first;
    }
    if (groups == nullptr) {
      total = 0;  // the requested scheme has no members: the no-scheme
                  // error arm below answers (an empty fan must never
                  // reach fan_wait — it would have nothing to wake it)
    } else {
      ctx.subs.resize((size_t)total);
      for (int p = 0; p < total; p++) {
        ctx.subs[p].ctx = &ctx;
        // rr among the partition's usable members (shared cursor: the
        // pick rotates across calls like a per-partition sub-LB)
        const std::vector<uint32_t>* g =
            p < (int)groups->size() ? &(*groups)[p] : nullptr;
        if (g != nullptr && !g->empty()) {
          uint64_t cur =
              c->cursor.fetch_add(1, std::memory_order_relaxed);
          for (size_t step = 0; step < g->size(); step++) {
            NatLbBackend* b =
                v->backends[(*g)[(cur + step) % g->size()]];
            if (nat_lb_backend_usable(b)) {
              ctx.subs[p].b = b;
              NAT_REF_ACQUIRE(b, clus.call);
              break;
            }
          }
        }
        if (ctx.subs[p].b == nullptr) {
          ctx.subs[p].err = kEFAILEDSOCKET;
          ctx.subs[p].err_text = "no backend for partition";
        }
      }
    }
    c->gate.exit(tok);
  }
  if (total == 0) {
    NAT_REF_RELEASE(c, clus.verb);
    if (err_text_out != nullptr) {
      const char* msg = "no partition-tagged backends";
      // natcheck:allow(resacct): FFI error text, freed by the caller
      *err_text_out = (char*)malloc(strlen(msg) + 1);
      memcpy(*err_text_out, msg, strlen(msg) + 1);
    }
    // natcheck:allow(refown-leak-path): total == 0 means the group walk
    // above never ran, so no clus.call reference is held on this arm
    return kETOOMANYFAILS;
  }
  // natcheck:allow(refown-leak-path): every seated partition sub's
  // clus.call is released by fan_run (fan_account_and_finish)
  return fan_run(c, &ctx, "partition", fail_limit, resp_out, resp_len,
                 err_text_out, failed_out);
}

// DynamicPartitionChannel verb (combo_channels.DynamicPartitionChannel
// natively): the partition count is not fixed — every call picks a
// scheme from the live version's "i/n" totals, weighted by capacity
// (_dynpart, SURVEY §2.6), then fans one sub-call per group exactly
// like partition_call. The scheme pick and the seat walk happen under
// ONE gate pin, so a resize published mid-call is invisible: the fan
// completes against its pinned version while new calls land on the new
// scheme mix. scheme_out reports the chosen part_total (observability +
// the equivalence probe).
int nat_cluster_dynpart_call(void* h, const char* service,
                             const char* method, const char* payload,
                             size_t payload_len, int timeout_ms,
                             int fail_limit, char** resp_out,
                             size_t* resp_len, char** err_text_out,
                             int* failed_out, int* scheme_out) {
  NatCluster* c = cluster_pin(h);
  if (resp_out != nullptr) {
    *resp_out = nullptr;
    *resp_len = 0;
  }
  if (err_text_out != nullptr) *err_text_out = nullptr;
  if (failed_out != nullptr) *failed_out = 0;
  if (scheme_out != nullptr) *scheme_out = 0;
  if (c == nullptr) return kEFAILEDSOCKET;
  FanCtx ctx;
  ctx.service = service;
  ctx.method = method;
  ctx.payload = payload;
  ctx.payload_len = payload_len;
  ctx.timeout_ms = timeout_ms;
  ctx.parent = nat_begin_call_trace();
  int total = 0;
  {
    int tok = c->gate.enter();
    const ServerListVer* v = c->cur.load(std::memory_order_seq_cst);
    total = nat_lb_dynpart_pick(v, nat_lb_rand01());
    if (total > 0) {
      auto it = v->parts.find(total);
      // pick() only returns totals present in v->parts with nonzero
      // capacity, so the find always lands — guard anyway (a capacity-0
      // fallback arm in pick would otherwise seat an empty fan)
      if (it == v->parts.end()) {
        total = 0;
      } else {
        const std::vector<std::vector<uint32_t>>& groups = it->second;
        ctx.subs.resize((size_t)total);
        for (int p = 0; p < total; p++) {
          ctx.subs[p].ctx = &ctx;
          const std::vector<uint32_t>* g =
              p < (int)groups.size() ? &groups[p] : nullptr;
          if (g != nullptr && !g->empty()) {
            uint64_t cur =
                c->cursor.fetch_add(1, std::memory_order_relaxed);
            for (size_t step = 0; step < g->size(); step++) {
              NatLbBackend* b =
                  v->backends[(*g)[(cur + step) % g->size()]];
              if (nat_lb_backend_usable(b)) {
                ctx.subs[p].b = b;
                NAT_REF_ACQUIRE(b, clus.call);
                break;
              }
            }
          }
          if (ctx.subs[p].b == nullptr) {
            ctx.subs[p].err = kEFAILEDSOCKET;
            ctx.subs[p].err_text = "no backend for partition";
          }
        }
      }
    }
    c->gate.exit(tok);
  }
  if (scheme_out != nullptr) *scheme_out = total;
  if (total == 0) {
    NAT_REF_RELEASE(c, clus.verb);
    if (err_text_out != nullptr) {
      const char* msg = "no partition scheme with capacity";
      // natcheck:allow(resacct): FFI error text, freed by the caller
      *err_text_out = (char*)malloc(strlen(msg) + 1);
      memcpy(*err_text_out, msg, strlen(msg) + 1);
    }
    // natcheck:allow(refown-leak-path): total == 0 means the seat walk
    // above never ran, so no clus.call reference is held on this arm
    return kETOOMANYFAILS;
  }
  // natcheck:allow(refown-leak-path): every seated dynpart sub's
  // clus.call is released by fan_run (fan_account_and_finish)
  return fan_run(c, &ctx, "dynpart", fail_limit, resp_out, resp_len,
                 err_text_out, failed_out);
}

// Equivalence probe for the dynpart pick (tests + /status debugging):
// dumps the live version's scheme table — ascending part_total order
// with each scheme's capacity — and the scheme the weighted walk picks
// for a CALLER-SUPPLIED point x01, so the Python DynPartLB walk can be
// replayed against the identical inputs. Returns the scheme count (may
// exceed max_schemes; only max_schemes rows are written).
int nat_cluster_dynpart_debug(void* h, double x01, int* totals_out,
                              int* caps_out, int max_schemes,
                              int* chosen_out) {
  NatCluster* c = cluster_pin(h);
  if (chosen_out != nullptr) *chosen_out = 0;
  if (c == nullptr) return 0;
  int n = 0;
  {
    int tok = c->gate.enter();
    const ServerListVer* v = c->cur.load(std::memory_order_seq_cst);
    for (const auto& kv : v->parts) {
      if (n < max_schemes) {
        if (totals_out != nullptr) totals_out[n] = kv.first;
        if (caps_out != nullptr) {
          caps_out[n] = nat_lb_dynpart_capacity(v, kv.first);
        }
      }
      n++;
    }
    if (chosen_out != nullptr) *chosen_out = nat_lb_dynpart_pick(v, x01);
    c->gate.exit(tok);
  }
  NAT_REF_RELEASE(c, clus.verb);
  return n;
}

// Per-backend observability rows (the /status cluster table and the
// nat_cluster_* Prometheus rows ride this).
int nat_cluster_stats(void* h, NatClusterRow* out, int max) {
  NatCluster* c = cluster_pin(h);
  if (c == nullptr) return 0;
  int n = 0;
  {
    std::lock_guard g(c->cluster_mu);
    for (auto& kv : c->members) {
      if (n >= max) break;
      NatLbBackend* b = kv.second;
      NatClusterRow* r = &out[n++];
      memset(r, 0, sizeof(*r));
      r->selects = b->selects.load(std::memory_order_relaxed);
      r->errors = b->errors.load(std::memory_order_relaxed);
      r->inflight = b->inflight.load(std::memory_order_relaxed);
      r->ema_latency_us = b->ema_lat_us.load(std::memory_order_relaxed);
      r->weight = b->weight.load(std::memory_order_relaxed);
      NatChannel* ch = b->ch;
      r->breaker_open =
          ch != nullptr &&
                  ch->breaker_broken.load(std::memory_order_acquire)
              ? 1
              : 0;
      r->lame_duck = ch != nullptr && ch->draining_recent() ? 1 : 0;
      r->part_index = b->part_idx;
      r->part_total = b->part_total;
      memcpy(r->endpoint, b->endpoint, sizeof(r->endpoint));
      memcpy(r->tag, b->tag, sizeof(r->tag));
    }
  }
  NAT_REF_RELEASE(c, clus.verb);
  return n;
}

// Fan-out bench loop (bench.py fanout lanes + the swarm churn drill):
// `concurrency` pthreads drive mode 0 (selective; param = max_retry),
// mode 1 (parallel; param = fail_limit), or mode 2 (dynpart; param =
// fail_limit — the autoscale drill's flood) calls for `seconds`. Returns
// qps; out_calls/out_failed count completed verbs; out_p99_us reports
// the verb-latency p99 from merged log2 histograms.
double nat_cluster_bench(void* h, int mode, const char* service,
                         const char* method, const char* payload,
                         size_t payload_len, int timeout_ms, int param,
                         double seconds, int concurrency,
                         uint64_t* out_calls, uint64_t* out_failed,
                         double* out_p99_us) {
  NatCluster* c = cluster_pin(h);
  if (c == nullptr) return 0.0;
  if (concurrency < 1) concurrency = 1;
  if (concurrency > 64) concurrency = 64;
  std::atomic<uint64_t> calls{0};
  std::atomic<uint64_t> failed{0};
  std::vector<std::vector<uint64_t>> hists(
      (size_t)concurrency, std::vector<uint64_t>(kNatHistBuckets, 0));
  uint64_t t_begin = nat_now_ns();
  uint64_t deadline = t_begin + (uint64_t)(seconds * 1e9);
  std::vector<std::thread> threads;
  threads.reserve((size_t)concurrency);
  for (int t = 0; t < concurrency; t++) {
    threads.emplace_back([&, t] {
      uint64_t* hist = hists[(size_t)t].data();
      uint64_t code = (uint64_t)t * 7919u;  // chash key stream
      while (nat_now_ns() < deadline) {
        char* resp = nullptr;
        size_t rlen = 0;
        char* err = nullptr;
        uint64_t t0 = nat_now_ns();
        int rc;
        if (mode == 2) {
          int nfail = 0;
          int scheme = 0;
          rc = nat_cluster_dynpart_call(h, service, method, payload,
                                        payload_len, timeout_ms, param,
                                        &resp, &rlen, &err, &nfail,
                                        &scheme);
        } else if (mode == 1) {
          int nfail = 0;
          rc = nat_cluster_parallel_call(h, service, method, payload,
                                         payload_len, timeout_ms, param,
                                         &resp, &rlen, &err, &nfail);
        } else {
          rc = nat_cluster_call(h, service, method, payload, payload_len,
                                timeout_ms, param, code++, &resp, &rlen,
                                &err);
        }
        hist[nat_hist_bucket(nat_now_ns() - t0)]++;
        calls.fetch_add(1, std::memory_order_relaxed);
        if (rc != 0) failed.fetch_add(1, std::memory_order_relaxed);
        if (resp != nullptr) free(resp);
        if (err != nullptr) free(err);
      }
    });
  }
  for (std::thread& th : threads) th.join();
  double dt = (double)(nat_now_ns() - t_begin) / 1e9;
  if (dt <= 0) dt = seconds > 0 ? seconds : 1.0;
  uint64_t total = calls.load(std::memory_order_relaxed);
  if (out_calls != nullptr) *out_calls = total;
  if (out_failed != nullptr) {
    *out_failed = failed.load(std::memory_order_relaxed);
  }
  if (out_p99_us != nullptr) {
    std::vector<uint64_t> merged((size_t)kNatHistBuckets, 0);
    for (const auto& hh : hists) {
      for (int b = 0; b < kNatHistBuckets; b++) merged[(size_t)b] += hh[(size_t)b];
    }
    *out_p99_us =
        nat_hist_quantile(merged.data(), kNatHistBuckets, 0.99) / 1e3;
  }
  NAT_REF_RELEASE(c, clus.verb);
  return (double)total / dt;
}

}  // extern "C"

}  // namespace brpc_tpu
