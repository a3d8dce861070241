// IOBuf — refcounted non-contiguous buffer, native counterpart of
// butil::IOBuf (/root/reference/src/butil/iobuf.h:64): chains of
// (block, offset, length) refs over 8KB refcounted blocks; append/cut move
// refs, not bytes; scatter-gather fd IO via readv/writev.
//
// Perf discipline (iobuf.cpp:323-445 in the reference: TLS block cache;
// iobuf.h:77-104: small-view union): the ref list is an INLINE array with
// a heap spill-over, so constructing/destroying an IOBuf in the per-call
// hot path costs zero allocations, and freed blocks go to a per-thread
// cache instead of the allocator.
#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <sys/uio.h>

#include "nat_refown.h"
#include "nat_res.h"

namespace brpc_tpu {

struct IOBlock {
  // constexpr (implicitly inline in C++17): `static const` has no
  // out-of-line definition, and unoptimized/sanitizer builds odr-use it
  static constexpr size_t kSize = 8192;  // iobuf.h:70
  std::atomic<int> ref{1};
  size_t size = 0;  // filled prefix
  // Arena-backed USER block (the registered-arena seam of the reference's
  // rdma docs: payloads live in registered memory and IOBuf carries refs
  // into it): when user_ptr is set the payload lives in FOREIGN memory —
  // a shm blob-arena span, a device staging buffer — and user_free(
  // user_arg) runs on the last release instead of the TLS-cache recycle.
  // User blocks are read-only to the append paths (left() == 0) and may
  // be larger than kSize.
  char* user_ptr = nullptr;
  void (*user_free)(void*) = nullptr;
  void* user_arg = nullptr;
  // free-pool linkage (iobuf.cpp): while a block sits in a thread cache
  // or the central batch pool this links it to the next free block —
  // blocks migrate between cores in batches of 8 instead of through
  // malloc's arena locks (the reference's block-pool free_chunk shape,
  // iobuf.cpp:217-319).
  IOBlock* pool_next = nullptr;
  char data[kSize];

  static IOBlock* create();   // TLS-cached (share_tls_block discipline)
  static IOBlock* create_user(const char* p, size_t len,
                              void (*free_fn)(void*), void* arg);
  static void recycle(IOBlock* b);
  void add_ref() { ref.fetch_add(1, std::memory_order_relaxed); }
  void release() {
    if (ref.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      NAT_REF_DEAD(this);  // refguard: every tag balanced before recycle
      recycle(this);
    }
  }
  size_t left() const { return user_ptr != nullptr ? 0 : kSize - size; }
  char* payload() { return user_ptr != nullptr ? user_ptr : data; }
  const char* payload() const {
    return user_ptr != nullptr ? user_ptr : data;
  }
};

struct BlockRef {
  IOBlock* block;
  uint32_t offset;
  uint32_t length;
};

class IOBuf {
 public:
  IOBuf() = default;
  ~IOBuf() {
    clear();
    release_refs_array();
  }
  IOBuf(const IOBuf& other) { append(other); }
  IOBuf& operator=(const IOBuf& other) {
    if (this != &other) {
      clear();
      append(other);
    }
    return *this;
  }
  IOBuf(IOBuf&& other) noexcept { steal(std::move(other)); }
  IOBuf& operator=(IOBuf&& other) noexcept {
    if (this != &other) {
      clear();
      release_refs_array();
      refs_ = inline_;
      cap_ = kInlineRefs;
      steal(std::move(other));
    }
    return *this;
  }

  size_t length() const { return length_; }
  bool empty() const { return length_ == 0; }

  void clear() {
    for (uint32_t i = 0; i < count_; i++) {
      NAT_REF_RELEASE(refs_[begin_ + i].block, iob.ref);
    }
    begin_ = 0;
    count_ = 0;
    length_ = 0;
  }

  void append(const void* data, size_t n);
  void append(const std::string& s) { append(s.data(), s.size()); }
  void append(const IOBuf& other);  // ref share (short buffers flat-copy)
  void append(IOBuf&& other);       // ref splice (short buffers flat-copy)
  void append_flat_from(const IOBuf& src, size_t n);  // forced flat copy
  // Zero-copy append of foreign memory (blob-arena span): the bytes are
  // NOT copied; free_fn(arg) runs when the last ref releases (after the
  // socket writev consumed them, or on clear()).
  void append_user(const char* p, size_t n, void (*free_fn)(void*),
                   void* arg);

  // move first n bytes of this into out (zero-copy)
  size_t cut_into(IOBuf* out, size_t n);
  // Inline fast path: the overwhelmingly common shape on the cut loop is
  // a pop that stays inside the front block (frames are far smaller than
  // the 8KB blocks) — one offset bump, no loop, no release.
  size_t pop_front(size_t n) {
    if (count_ > 0) {
      BlockRef& r = refs_[begin_];
      if (r.length > n) {
        r.offset += (uint32_t)n;
        r.length -= (uint32_t)n;
        length_ -= n;
        return n;
      }
    }
    return pop_front_slow(n);
  }
  size_t copy_to(void* out, size_t n, size_t pos = 0) const {
    if (count_ > 0) {
      const BlockRef& r = refs_[begin_];
      if (pos + n <= r.length) {  // entirely inside the front block
        memcpy(out, r.block->payload() + r.offset + pos, n);
        return n;
      }
    }
    return copy_to_slow(out, n, pos);
  }
  std::string to_string() const;

  // Contiguous view of the first n bytes: returns a pointer into the first
  // block when the range doesn't straddle blocks (the common case for
  // headers/meta), else copies into scratch. n must be <= scratch capacity.
  const char* fetch(char* scratch, size_t n) const {
    if (count_ > 0) {
      const BlockRef& r = refs_[begin_];
      if (r.length >= n) return r.block->payload() + r.offset;
    }
    copy_to(scratch, n);
    return scratch;
  }

  // scatter-gather IO
  ssize_t cut_into_fd(int fd, size_t max_bytes = SIZE_MAX);
  ssize_t append_from_fd(int fd, size_t max_bytes = 65536);

  uint32_t ref_count() const { return count_; }  // observability/tests

 private:
  static const uint32_t kInlineRefs = 6;

  // Free a spilled (heap) ref array and retire its ledger bytes — the
  // one release seam paired with make_room's NAT_RES_ALLOC.
  void release_refs_array() {
    if (refs_ != inline_) {
      NAT_RES_FREE(NR_IOBUF_REFS, cap_ * sizeof(BlockRef), refs_);
      ::free(refs_);
    }
  }

  size_t pop_front_slow(size_t n);
  size_t copy_to_slow(void* out, size_t n, size_t pos) const;
  void push_ref(IOBlock* b, uint32_t off, uint32_t len);

  BlockRef& front() { return refs_[begin_]; }
  const BlockRef& at(uint32_t i) const { return refs_[begin_ + i]; }

  void push_back(const BlockRef& r) {
    if (begin_ + count_ == cap_) make_room();
    refs_[begin_ + count_] = r;
    count_++;
  }

  void drop_front() {  // caller already released the ref
    begin_++;
    count_--;
    if (count_ == 0) begin_ = 0;
  }

  void make_room();  // compact to 0 or grow the heap array
  void steal(IOBuf&& other);

  BlockRef inline_[kInlineRefs];
  BlockRef* refs_ = inline_;
  uint32_t begin_ = 0;
  uint32_t count_ = 0;
  uint32_t cap_ = kInlineRefs;
  size_t length_ = 0;
};

// Pooled bulk read slabs — the read-side registered-arena role of the
// reference's block_pool (docs/cn/rdma.md: ALL IOBuf memory comes from
// the registered pool so payloads are transfer-ready). Large tpu_std
// frame bodies read straight into one slab (no per-8KB block churn) and
// join the stream as a single arena-backed USER block. Slabs are
// power-of-two capacities recycled through a small freelist so bulk
// traffic doesn't pay malloc/mmap + first-touch faults per frame.
// cap_out receives the slab capacity — the release key.
char* iob_bulk_acquire(size_t need, size_t* cap_out);
void iob_bulk_release(char* p, size_t cap);
// append_user free_fn adapter: arg is the BulkCtx made by iob_bulk_ctx.
void iob_bulk_user_free(void* raw);
void* iob_bulk_ctx(char* p, size_t cap);

}  // namespace brpc_tpu
