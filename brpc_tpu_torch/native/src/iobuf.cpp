#include "iobuf.h"

#include "nat_api.h"
#include "nat_lockrank.h"

#include <errno.h>
#include <stdlib.h>
#include <unistd.h>
#include <algorithm>
#include <vector>  // std::vector below: not every libstdc++ pulls it in

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// Block pool — two tiers (the reference's share_tls_block + global
// free-chunk pool, iobuf.cpp:217-445), the multicore lever: a block freed
// by a dispatcher thread on core B re-enters circulation through an
// 8-block BATCH transfer instead of `delete` (malloc arena locks) or a
// per-block shared freelist (one contended cache line per block). The
// amortized cross-core cost is one short lock hold per 8 blocks; within
// a thread, create/recycle stay pure TLS pointer ops.
// ---------------------------------------------------------------------------

static constexpr size_t kBlockBatch = 8;

// central pool of 8-block chains (linked via IOBlock::pool_next)
struct CentralBlockPool {
  NatMutex<kLockRankBlockPool> pool_mu;
  std::vector<IOBlock*> batches;       // each entry: chain of kBlockBatch
  static constexpr size_t kMaxBatches = 64;  // 4MB cap; beyond -> delete
};
// natcheck:leak(g_block_pool): leaked like every runtime static —
// threads keep recycling blocks through exit()
static CentralBlockPool& g_block_pool = *new CentralBlockPool();

// The ONLY raw allocation/release seam for 8KB blocks: every block in a
// TLS cache or the central batch pool is LIVE in the ledger — the
// conn-scale drill's "where do 20k connections' bytes sit" answer needs
// parked pool memory attributed, not just in-flight buffers.
static IOBlock* block_new() {
  IOBlock* b = new IOBlock();  // ctor ref{1}
  NAT_RES_ALLOC(NR_IOBUF_BLOCK, sizeof(IOBlock), b);
  return b;
}

static void block_delete(IOBlock* b) {
  NAT_RES_FREE(NR_IOBUF_BLOCK, sizeof(IOBlock), b);
  delete b;
}

// Per-thread block cache: blocks freed on this thread are kept for reuse;
// overflow returns WHOLE BATCHES to the central pool, refill steals them.
struct TlsBlockCache {
  static const size_t kCap = 64;  // 512KB per thread, bounded
  IOBlock* blocks[kCap];
  size_t n = 0;
  // this thread's shared tail block (share_tls_block analog); lives in
  // the cache struct so thread exit releases the creator reference —
  // short-lived writer threads used to leak exactly this block
  IOBlock* share = nullptr;
  ~TlsBlockCache() {
    if (share != nullptr) {
      // drop the creator ref WITHOUT IOBlock::release(): a zero refcount
      // must not recycle into this half-destroyed cache
      NAT_REF_RELEASED(share, iob.share);
      if (share->ref.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        NAT_REF_DEAD(share);
        block_delete(share);
      }
      share = nullptr;
    }
    // thread exit: hand complete batches back to the central pool (they
    // stay reachable through the leaked pool — warm for other threads);
    // the sub-batch remainder is freed.
    while (n >= kBlockBatch) {
      IOBlock* head = nullptr;
      for (size_t i = 0; i < kBlockBatch; i++) {
        IOBlock* b = blocks[--n];
        b->pool_next = head;
        head = b;
      }
      std::lock_guard g(g_block_pool.pool_mu);
      if (g_block_pool.batches.size() < CentralBlockPool::kMaxBatches) {
        g_block_pool.batches.push_back(head);
        head = nullptr;
      }
      if (head != nullptr) {
        while (head != nullptr) {
          IOBlock* next = head->pool_next;
          block_delete(head);
          head = next;
        }
      }
    }
    for (size_t i = 0; i < n; i++) block_delete(blocks[i]);
  }
};
static thread_local TlsBlockCache tls_cache;

IOBlock* IOBlock::create() {
  TlsBlockCache& c = tls_cache;
  if (c.n == 0) {
    // refill: steal one batch (8 blocks for one lock hold)
    IOBlock* head = nullptr;
    {
      std::lock_guard g(g_block_pool.pool_mu);
      if (!g_block_pool.batches.empty()) {
        head = g_block_pool.batches.back();
        g_block_pool.batches.pop_back();
      }
    }
    while (head != nullptr) {
      IOBlock* next = head->pool_next;
      head->pool_next = nullptr;
      c.blocks[c.n++] = head;
      head = next;
    }
  }
  IOBlock* b;
  if (c.n > 0) {
    b = c.blocks[--c.n];
    b->ref.store(1, std::memory_order_relaxed);
    b->size = 0;
  } else {
    b = block_new();
  }
  // the initial reference: the creating scope releases it or transfers
  // it (to iob.share / the first BlockRef)
  NAT_REF_ACQUIRED(b, iob.creator);
  return b;
}

void IOBlock::recycle(IOBlock* b) {
  if (b->user_ptr != nullptr) {
    // arena-backed user block: run the release action (arena span free,
    // device buffer unpin) and strip the user fields so the header can
    // re-enter the cache as a normal block. The HEADER recycles into the
    // RELEASING thread's cache (below) — the span itself returns to its
    // owner arena's freelist inside user_free, so neither side bounces
    // the other's cache lines.
    if (b->user_free != nullptr) b->user_free(b->user_arg);
    b->user_ptr = nullptr;
    b->user_free = nullptr;
    b->user_arg = nullptr;
  }
  TlsBlockCache& c = tls_cache;
  if (c.n >= TlsBlockCache::kCap) {
    // overflow: return one batch to the central pool so a hot freeing
    // thread (a dispatcher draining another core's responses) feeds the
    // allocating threads instead of the allocator
    IOBlock* head = nullptr;
    for (size_t i = 0; i < kBlockBatch; i++) {
      IOBlock* ob = c.blocks[--c.n];
      ob->pool_next = head;
      head = ob;
    }
    {
      std::lock_guard g(g_block_pool.pool_mu);
      if (g_block_pool.batches.size() < CentralBlockPool::kMaxBatches) {
        g_block_pool.batches.push_back(head);
        head = nullptr;
      }
    }
    while (head != nullptr) {  // central pool full: free the batch
      IOBlock* next = head->pool_next;
      block_delete(head);
      head = next;
    }
  }
  c.blocks[c.n++] = b;
}

IOBlock* IOBlock::create_user(const char* p, size_t len,
                              void (*free_fn)(void*), void* arg) {
  IOBlock* b = create();
  b->user_ptr = const_cast<char*>(p);
  b->user_free = free_fn;
  b->user_arg = arg;
  b->size = len;
  return b;
}

// ---------------------------------------------------------------------------
// Bulk slab pool (read-side arena blocks for bulk frames, ISSUE 15):
// power-of-two slabs 64KB..8MB recycled through per-class freelists; a
// parked slab stays LIVE in the ledger like every parked pool block.
// Frames past the max class fall back to an exact-size unpooled malloc.
// ---------------------------------------------------------------------------

static constexpr size_t kBulkMinSlab = 64u << 10;
static constexpr size_t kBulkMaxSlab = 8u << 20;
static constexpr int kBulkClasses = 8;  // 64K 128K ... 8M
static constexpr int kBulkPoolDepth = 4;

struct BulkSlabPool {
  NatMutex<kLockRankBulkPool> bulk_mu;
  char* free_[kBulkClasses][kBulkPoolDepth];
  int n_[kBulkClasses] = {};
};
// natcheck:leak(g_bulk_pool): leaked like every runtime static — read
// paths keep releasing slabs through exit()
static BulkSlabPool& g_bulk_pool = *new BulkSlabPool();

static int bulk_class(size_t cap) {
  if (cap < kBulkMinSlab || cap > kBulkMaxSlab || (cap & (cap - 1)) != 0) {
    return -1;  // unpooled (exact-size giant frame)
  }
  int cls = 0;
  for (size_t c = kBulkMinSlab; c < cap; c <<= 1) cls++;
  return cls;
}

char* iob_bulk_acquire(size_t need, size_t* cap_out) {
  size_t cap = kBulkMinSlab;
  while (cap < need && cap < kBulkMaxSlab) cap <<= 1;
  if (need > cap) cap = need;  // giant frame: exact size, unpooled
  int cls = bulk_class(cap);
  if (cls >= 0) {
    std::lock_guard g(g_bulk_pool.bulk_mu);
    if (g_bulk_pool.n_[cls] > 0) {
      *cap_out = cap;
      return g_bulk_pool.free_[cls][--g_bulk_pool.n_[cls]];
    }
  }
  char* p = (char*)::malloc(cap);
  if (p != nullptr) NAT_RES_ALLOC(NR_IOBUF_BLOCK, cap, p);
  *cap_out = cap;
  return p;
}

void iob_bulk_release(char* p, size_t cap) {
  if (p == nullptr) return;
  int cls = bulk_class(cap);
  if (cls >= 0) {
    std::lock_guard g(g_bulk_pool.bulk_mu);
    if (g_bulk_pool.n_[cls] < kBulkPoolDepth) {
      g_bulk_pool.free_[cls][g_bulk_pool.n_[cls]++] = p;
      return;  // parked: stays LIVE in the ledger
    }
  }
  NAT_RES_FREE(NR_IOBUF_BLOCK, cap, p);
  ::free(p);
}

// (slab, capacity) context threaded through append_user's single arg
struct BulkCtx {
  char* p;
  size_t cap;
};

void* iob_bulk_ctx(char* p, size_t cap) {
  BulkCtx* c = new BulkCtx{p, cap};
  NAT_RES_ALLOC(NR_IOBUF_REFS, sizeof(BulkCtx), c);
  return c;
}

void iob_bulk_user_free(void* raw) {
  BulkCtx* c = (BulkCtx*)raw;
  iob_bulk_release(c->p, c->cap);
  NAT_RES_FREE(NR_IOBUF_REFS, sizeof(BulkCtx), c);
  delete c;
}

static IOBlock* tls_share_block() {
  TlsBlockCache& c = tls_cache;
  if (c.share == nullptr || c.share->left() == 0) {
    if (c.share) NAT_REF_RELEASE(c.share, iob.share);
    c.share = IOBlock::create();
    NAT_REF_TRANSFER(c.share, iob.creator, iob.share);
  }
  return c.share;
}

void IOBuf::make_room() {
  if (begin_ > 0) {  // compact: reuse the vacated front
    memmove(refs_, refs_ + begin_, count_ * sizeof(BlockRef));
    begin_ = 0;
    return;
  }
  uint32_t ncap = cap_ * 2;
  BlockRef* nrefs = (BlockRef*)::malloc(ncap * sizeof(BlockRef));
  NAT_RES_ALLOC(NR_IOBUF_REFS, ncap * sizeof(BlockRef), nrefs);
  memcpy(nrefs, refs_ + begin_, count_ * sizeof(BlockRef));
  release_refs_array();
  refs_ = nrefs;
  cap_ = ncap;
  begin_ = 0;
}

void IOBuf::steal(IOBuf&& other) {
  if (other.refs_ == other.inline_) {
    memcpy(inline_, other.inline_ + other.begin_,
           other.count_ * sizeof(BlockRef));
    refs_ = inline_;
    begin_ = 0;
    cap_ = kInlineRefs;
  } else {
    refs_ = other.refs_;
    begin_ = other.begin_;
    cap_ = other.cap_;
    other.refs_ = other.inline_;
    other.cap_ = kInlineRefs;
  }
  count_ = other.count_;
  length_ = other.length_;
  other.begin_ = 0;
  other.count_ = 0;
  other.length_ = 0;
}

void IOBuf::push_ref(IOBlock* b, uint32_t off, uint32_t len) {
  if (len == 0) return;
  if (count_ > 0) {
    BlockRef& tail = refs_[begin_ + count_ - 1];
    if (tail.block == b && tail.offset + tail.length == off) {
      tail.length += len;  // merge contiguous refs
      length_ += len;
      return;
    }
  }
  NAT_REF_ACQUIRE(b, iob.ref);
  push_back({b, off, len});
  length_ += len;
}

void IOBuf::append(const void* data, size_t n) {
  const char* p = (const char*)data;
  while (n > 0) {
    IOBlock* b = tls_share_block();
    size_t take = std::min(n, b->left());
    memcpy(b->data + b->size, p, take);
    push_ref(b, (uint32_t)b->size, (uint32_t)take);
    b->size += take;
    p += take;
    n -= take;
  }
}

void IOBuf::append_user(const char* p, size_t n, void (*free_fn)(void*),
                        void* arg) {
  if (n == 0) {
    if (free_fn != nullptr) free_fn(arg);
    return;
  }
  IOBlock* b = IOBlock::create_user(p, n, free_fn, arg);
  NAT_REF_TRANSFER(b, iob.creator, iob.ref);  // the IOBuf owns it now
  push_back({b, 0, (uint32_t)n});
  length_ += n;
}

// Below this, splicing refs costs more than copying the bytes: every
// spliced ref is two atomic RMWs (add_ref now, release later), a ref-slot
// push, and one more iovec for the eventual writev — while a short memcpy
// into the shared tail block merges into the previous ref and vanishes.
// The r03 flat profile showed exactly this: no single hotspot, the cycles
// spread across IOBlock::release / cut_into / push_back on ~40-byte
// frames. (The reference trades the same way: its IOBuf::append_to copies
// short data instead of sharing blocks.)
static const size_t kSmallCopy = 512;

// Copy the first n bytes of src's refs into this buffer's shared tail
// block(s) — the one-memcpy-per-block flat path behind the small-copy
// appends (no stack bounce).
void IOBuf::append_flat_from(const IOBuf& src, size_t n) {
  size_t left = n;
  for (uint32_t i = 0; i < src.count_ && left > 0; i++) {
    const BlockRef& r = src.at(i);
    size_t take = std::min((size_t)r.length, left);
    append(r.block->payload() + r.offset, take);
    left -= take;
  }
}

void IOBuf::append(const IOBuf& other) {
  if (other.length_ <= kSmallCopy && other.length_ > 0) {
    append_flat_from(other, other.length_);
    return;
  }
  for (uint32_t i = 0; i < other.count_; i++) {
    const BlockRef& r = other.at(i);
    NAT_REF_ACQUIRE(r.block, iob.ref);
    push_back(r);
    length_ += r.length;
  }
}

void IOBuf::append(IOBuf&& other) {
  if (count_ == 0) {
    release_refs_array();
    refs_ = inline_;
    cap_ = kInlineRefs;
    steal(std::move(other));
    return;
  }
  if (other.length_ <= kSmallCopy) {
    if (other.length_ > 0) append_flat_from(other, other.length_);
    other.clear();
    return;
  }
  for (uint32_t i = 0; i < other.count_; i++) {
    push_back(other.at(i));  // refs transfer as-is
  }
  length_ += other.length_;
  other.begin_ = 0;
  other.count_ = 0;
  other.length_ = 0;
}

size_t IOBuf::cut_into(IOBuf* out, size_t n) {
  n = std::min(n, length_);
  if (n > 0 && n <= kSmallCopy) {
    out->append_flat_from(*this, n);
    pop_front(n);
    return n;
  }
  size_t remain = n;
  while (remain > 0) {
    BlockRef& r = front();
    if (r.length <= remain) {
      out->push_back(r);  // transfer ref ownership
      out->length_ += r.length;
      remain -= r.length;
      length_ -= r.length;
      drop_front();
    } else {
      NAT_REF_ACQUIRE(r.block, iob.ref);
      out->push_back({r.block, r.offset, (uint32_t)remain});
      out->length_ += remain;
      r.offset += remain;
      r.length -= remain;
      length_ -= remain;
      remain = 0;
    }
  }
  return n;
}

size_t IOBuf::pop_front_slow(size_t n) {
  n = std::min(n, length_);
  size_t remain = n;
  while (remain > 0) {
    BlockRef& r = front();
    if (r.length <= remain) {
      remain -= r.length;
      length_ -= r.length;
      NAT_REF_RELEASE(r.block, iob.ref);
      drop_front();
    } else {
      r.offset += remain;
      r.length -= remain;
      length_ -= remain;
      remain = 0;
    }
  }
  return n;
}

size_t IOBuf::copy_to_slow(void* out, size_t n, size_t pos) const {
  char* dst = (char*)out;
  size_t copied = 0, skip = pos;
  for (uint32_t i = 0; i < count_; i++) {
    const BlockRef& r = at(i);
    if (copied >= n) break;
    if (skip >= r.length) {
      skip -= r.length;
      continue;
    }
    size_t take = std::min((size_t)r.length - skip, n - copied);
    memcpy(dst + copied, r.block->payload() + r.offset + skip, take);
    copied += take;
    skip = 0;
  }
  return copied;
}

std::string IOBuf::to_string() const {
  std::string s;
  s.resize(length_);
  copy_to(&s[0], length_);
  return s;
}

// IO syscall counters (bvar-role observability for the native lane; read
// via nat_io_counters): how well write batching amortizes syscalls.
std::atomic<uint64_t> g_writev_calls{0};
std::atomic<uint64_t> g_writev_bytes{0};
std::atomic<uint64_t> g_read_calls{0};
std::atomic<uint64_t> g_read_bytes{0};

extern "C" void nat_io_counters(uint64_t* wc, uint64_t* wb, uint64_t* rc,
                                uint64_t* rb) {
  if (wc) *wc = g_writev_calls.load(std::memory_order_relaxed);
  if (wb) *wb = g_writev_bytes.load(std::memory_order_relaxed);
  if (rc) *rc = g_read_calls.load(std::memory_order_relaxed);
  if (rb) *rb = g_read_bytes.load(std::memory_order_relaxed);
}

ssize_t IOBuf::cut_into_fd(int fd, size_t max_bytes) {
  struct iovec iov[64];
  int niov = 0;
  size_t queued = 0;
  for (uint32_t i = 0; i < count_; i++) {
    const BlockRef& r = at(i);
    if (niov >= 64 || queued >= max_bytes) break;
    size_t take = std::min((size_t)r.length, max_bytes - queued);
    iov[niov].iov_base = r.block->payload() + r.offset;
    iov[niov].iov_len = take;
    niov++;
    queued += take;
  }
  if (niov == 0) return 0;
  ssize_t nw = writev(fd, iov, niov);
  if (nw > 0) {
    g_writev_calls.fetch_add(1, std::memory_order_relaxed);
    g_writev_bytes.fetch_add((uint64_t)nw, std::memory_order_relaxed);
    pop_front((size_t)nw);
  }
  return nw;
}

ssize_t IOBuf::append_from_fd(int fd, size_t max_bytes) {
  // Scatter read: the TLS share block's tail plus spare blocks, so one
  // syscall can move up to ~64KB (the IOPortal big-read discipline,
  // iobuf.h:455-497) — bulk transfers would crawl at 8KB/syscall
  // otherwise. Unused spares go straight back to the TLS cache.
  IOBlock* b = tls_share_block();
  struct iovec iov[9];
  IOBlock* spare[8];
  int nspare = 0;
  size_t want = std::min(max_bytes, b->left());
  iov[0].iov_base = b->data + b->size;
  iov[0].iov_len = want;
  int niov = 1;
  size_t capacity = want;
  while (capacity < max_bytes && nspare < 8) {
    IOBlock* sb = IOBlock::create();
    spare[nspare++] = sb;
    iov[niov].iov_base = sb->data;
    iov[niov].iov_len = IOBlock::kSize;
    niov++;
    capacity += IOBlock::kSize;
  }
  ssize_t n = readv(fd, iov, niov);
  if (n > 0) {
    g_read_calls.fetch_add(1, std::memory_order_relaxed);
    g_read_bytes.fetch_add((uint64_t)n, std::memory_order_relaxed);
    size_t remain = (size_t)n;
    size_t take = std::min(remain, want);
    push_ref(b, (uint32_t)b->size, (uint32_t)take);
    b->size += take;
    remain -= take;
    for (int i = 0; i < nspare; i++) {
      IOBlock* sb = spare[i];
      if (remain == 0) {
        NAT_REF_RELEASE(sb, iob.creator);  // unused: back to the cache
        continue;
      }
      take = std::min(remain, IOBlock::kSize);
      sb->size = take;
      push_ref(sb, 0, (uint32_t)take);
      remain -= take;
      if (sb->left() > 0) {
        // partially-filled spare becomes the new share block so the
        // next append continues filling it
        if (tls_cache.share != nullptr) {
          NAT_REF_RELEASE(tls_cache.share, iob.share);
        }
        NAT_REF_TRANSFER(sb, iob.creator, iob.share);
        tls_cache.share = sb;
      } else {
        NAT_REF_RELEASE(sb, iob.creator);  // full: only the IOBuf ref
      }
    }
  } else {
    for (int i = 0; i < nspare; i++) {
      NAT_REF_RELEASE(spare[i], iob.creator);
    }
  }
  return n;
}

}  // namespace brpc_tpu
