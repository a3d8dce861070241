// Descriptor ring + blob arena — the lock-free core of the shm lane
// (nat_shm_lane.cpp), extracted so the SAME code compiles under the
// dsched deterministic interleaving checker (native/model/, built with
// -DNAT_MODEL=1; see nat_atomic.h for the seam).
//
//   * DescRingT<Slots>: fixed 64B seq-numbered slots (the Vyukov
//     bounded-queue discipline). Producers are serialized by a
//     process-local lock and claim slots with desc_ring_begin_push /
//     publish with desc_ring_publish (which may run OUTSIDE the lock —
//     a claimed cell is private until its seq store). Consumers pop
//     lock-free with a CAS on the dequeue cursor.
//   * blob arena: a ring allocator over a caller-provided byte range.
//     Spans carry an 8-byte header (alloc_len | released bit), claim at
//     the tail (producer lock), never straddle the arena edge (a
//     released filler pads to it), release out of order (consumer), and
//     the producer lazily reclaims released spans from the head.
//
// Layout is shared-memory ABI: Slots=1024 in production (nat_shm_lane's
// ShmRing alias), tiny in the model so exhaustive exploration reaches
// ring wrap and arena wrap within bounded schedules.
#pragma once

#include <cstddef>
#include <cstdint>

#include "nat_atomic.h"

namespace brpc_tpu {

constexpr uint64_t kSpanReleased = 1ull << 63;
constexpr uint64_t kSpanLenMask = 0xffffffffull;

// plain snapshot of a popped descriptor (a cell minus the atomic)
struct DescCellView {
  uint64_t sock_id;
  int64_t cid;
  uint64_t span_off;
  uint64_t aux;
  uint32_t payload_len;
  int32_t status;
  uint8_t kind;
  uint8_t flags;
};

template <uint32_t Slots>  // power of two
struct DescRingT {
  static_assert((Slots & (Slots - 1)) == 0, "Slots must be a power of 2");
  static constexpr uint32_t kSlots = Slots;

  struct Cell {  // one descriptor slot (a cache line)
    nat::atomic<uint64_t> seq;  // Vyukov: pos = empty, pos+1 = filled,
                                // pos+Slots = free for the next lap
    uint64_t sock_id;
    int64_t cid;
    uint64_t span_off;  // monotone span-start offset in the blob arena
    uint64_t aux;       // tensor tag (kind 8)
    uint32_t payload_len;
    int32_t status;
    uint8_t kind;
    uint8_t flags;  // bit0: close_after
    char pad[14];
  };

  nat::atomic<uint64_t> enq_pos;  // producer cursor (producer-side lock)
  char pad0[56];
  nat::atomic<uint64_t> deq_pos;  // consumer cursor (CAS, multi-consumer)
  char pad1[56];
  // blob-arena cursors: tail bumps at claim (producer), head is the
  // producer's lazy reclaim cursor over released span headers
  nat::atomic<uint64_t> arena_head;
  nat::atomic<uint64_t> arena_tail;
  char pad2[48];
  Cell cells[Slots];
};

inline nat::atomic<uint64_t>* desc_span_hdr(char* arena, uint64_t span_off,
                                            uint64_t asize) {
  return (nat::atomic<uint64_t>*)(arena + (size_t)(span_off % asize));
}

inline char* desc_span_payload(char* arena, uint64_t span_off,
                               uint64_t asize) {
  return arena + (size_t)(span_off % asize) + 8;
}

inline void desc_span_release(char* arena, uint64_t span_off,
                              uint64_t asize) {
  desc_span_hdr(arena, span_off, asize)
      ->fetch_or(kSpanReleased, std::memory_order_acq_rel);
}

// reclaim released spans from the head (producer side; requires the
// producer lock of the ring that owns `arena`)
template <uint32_t Slots>
void desc_arena_reclaim(DescRingT<Slots>* r, char* arena, uint64_t asize) {
  uint64_t head = r->arena_head.load(std::memory_order_relaxed);
  uint64_t tail = r->arena_tail.load(std::memory_order_relaxed);
  while (head < tail) {
    uint64_t h =
        desc_span_hdr(arena, head, asize)->load(std::memory_order_acquire);
    uint64_t len = h & kSpanLenMask;
    if (!(h & kSpanReleased)) break;
    if (len == 0 || (len & 63) != 0 || len > asize) {
      break;  // desynced header: recovery scrubs, never chase garbage
    }
    head += len;
  }
  r->arena_head.store(head, std::memory_order_release);
}

// Claim a span able to hold `payload` bytes after its 8-byte header,
// 64-byte aligned, never straddling the arena edge (a released filler
// pads to it). Returns the monotone span offset or UINT64_MAX when full.
// Requires the producer lock.
template <uint32_t Slots>
uint64_t desc_arena_claim(DescRingT<Slots>* r, char* arena, size_t payload,
                          uint64_t asize) {
  uint64_t need = ((uint64_t)payload + 8 + 63) & ~63ull;
  if (need + 64 > asize) return UINT64_MAX;  // can never fit
  desc_arena_reclaim(r, arena, asize);
  uint64_t tail = r->arena_tail.load(std::memory_order_relaxed);
  uint64_t head = r->arena_head.load(std::memory_order_relaxed);
  uint64_t off = tail % asize;
  uint64_t fill = (off + need > asize) ? (asize - off) : 0;
  if (tail + fill + need - head > asize) return UINT64_MAX;  // full
  if (fill != 0) {
    desc_span_hdr(arena, tail, asize)
        ->store(fill | kSpanReleased, std::memory_order_release);
    tail += fill;
  }
  desc_span_hdr(arena, tail, asize)->store(need, std::memory_order_relaxed);
  r->arena_tail.store(tail + need, std::memory_order_release);
  return tail;
}

template <uint32_t Slots>
void desc_ring_init(DescRingT<Slots>* r) {
  r->enq_pos.store(0, std::memory_order_relaxed);
  r->deq_pos.store(0, std::memory_order_relaxed);
  r->arena_head.store(0, std::memory_order_relaxed);
  r->arena_tail.store(0, std::memory_order_relaxed);
  for (uint32_t i = 0; i < Slots; i++) {
    r->cells[i].seq.store(i, std::memory_order_relaxed);
  }
}

// Claim a slot + an arena span (requires the producer lock); the caller
// memcpys into *dst and then publishes with desc_ring_publish (which may
// run OUTSIDE the lock — the claimed cell is private until its seq
// store).
template <uint32_t Slots>
bool desc_ring_begin_push(DescRingT<Slots>* r, char* arena, size_t len,
                          uint64_t asize, uint64_t* pos_out,
                          uint64_t* span_out, char** dst) {
  uint64_t pos = r->enq_pos.load(std::memory_order_relaxed);
  typename DescRingT<Slots>::Cell* c = &r->cells[pos & (Slots - 1)];
  if (c->seq.load(std::memory_order_acquire) != pos) return false;  // full
  uint64_t span = desc_arena_claim(r, arena, len, asize);
  if (span == UINT64_MAX) return false;  // arena full (backpressure)
  r->enq_pos.store(pos + 1, std::memory_order_relaxed);
  *pos_out = pos;
  *span_out = span;
  *dst = desc_span_payload(arena, span, asize);
  return true;
}

template <uint32_t Slots>
void desc_ring_publish(DescRingT<Slots>* r, uint64_t pos, uint8_t kind,
                       uint8_t flags, uint64_t sock_id, int64_t cid,
                       int32_t status, uint64_t span, uint32_t payload_len,
                       uint64_t aux) {
  typename DescRingT<Slots>::Cell* c = &r->cells[pos & (Slots - 1)];
  c->kind = kind;
  c->flags = flags;
  c->sock_id = sock_id;
  c->cid = cid;
  c->status = status;
  c->span_off = span;
  c->payload_len = payload_len;
  c->aux = aux;
  c->seq.store(pos + 1, std::memory_order_release);
}

template <uint32_t Slots>
bool desc_ring_pop(DescRingT<Slots>* r, DescCellView* out) {
  for (;;) {
    uint64_t pos = r->deq_pos.load(std::memory_order_acquire);
    typename DescRingT<Slots>::Cell* c = &r->cells[pos & (Slots - 1)];
    // Not a seqlock — a Vyukov bounded queue: the deq_pos CAS below
    // grants EXCLUSIVE ownership of the cell before its payload is
    // read, and the producer cannot rewrite it until our seq store
    // frees the slot for the next lap.
    // natcheck:allow(seqlock-recheck): Vyukov cell, CAS-owned (above)
    uint64_t s = c->seq.load(std::memory_order_acquire);
    if (s == pos + 1) {  // filled
      if (!r->deq_pos.compare_exchange_weak(pos, pos + 1,
                                            std::memory_order_acq_rel,
                                            std::memory_order_acquire)) {
        continue;  // another consumer won this slot
      }
      out->sock_id = c->sock_id;
      out->cid = c->cid;
      out->span_off = c->span_off;
      out->aux = c->aux;
      out->payload_len = c->payload_len;
      out->status = c->status;
      out->kind = c->kind;
      out->flags = c->flags;
      // fields snapshotted: free the slot for the producer's next lap
      c->seq.store(pos + Slots, std::memory_order_release);
      return true;
    }
    if (s < pos + 1) return false;  // empty
    // s > pos + 1: a concurrent consumer advanced deq_pos; retry
  }
}

template <uint32_t Slots>
bool desc_ring_has_data(DescRingT<Slots>* r) {
  uint64_t pos = r->deq_pos.load(std::memory_order_acquire);
  return r->cells[pos & (Slots - 1)].seq.load(std::memory_order_acquire) ==
         pos + 1;
}

// Force-free a ring's claimed-but-unpublished cells (a producer died
// between claim and publish): without this the consumer can never pop
// past the unpublished seq and the ring wedges forever.
template <uint32_t Slots>
void desc_ring_discard_claims(DescRingT<Slots>* r) {
  uint64_t enq = r->enq_pos.load(std::memory_order_relaxed);
  uint64_t deq = r->deq_pos.load(std::memory_order_relaxed);
  for (; deq < enq; deq++) {
    r->cells[deq & (Slots - 1)].seq.store(deq + Slots,
                                          std::memory_order_relaxed);
  }
  r->deq_pos.store(enq, std::memory_order_release);
}

// Scrub every span header in [head, tail): after a dead worker's
// responses are drained and in-flight user blocks released, anything
// unreleased is its half-claimed garbage.
template <uint32_t Slots>
void desc_scrub_arena(DescRingT<Slots>* r, char* arena, uint64_t asize) {
  uint64_t head = r->arena_head.load(std::memory_order_relaxed);
  uint64_t tail = r->arena_tail.load(std::memory_order_relaxed);
  while (head < tail) {
    uint64_t h =
        desc_span_hdr(arena, head, asize)->load(std::memory_order_acquire);
    uint64_t len = h & kSpanLenMask;
    if (len == 0 || (len & 63) != 0 || len > asize) {
      // desynced header chain: drop the whole region (nothing references
      // it any more — cells are drained and user blocks released)
      r->arena_head.store(tail, std::memory_order_release);
      return;
    }
    desc_span_hdr(arena, head, asize)
        ->store(len | kSpanReleased, std::memory_order_release);
    head += len;
  }
  r->arena_head.store(head, std::memory_order_release);
}

}  // namespace brpc_tpu
