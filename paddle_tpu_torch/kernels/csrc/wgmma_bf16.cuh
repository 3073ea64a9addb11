// The bf16 tile loop for Hopper's warpgroup tensor cores (sm_90a): TMA
// loads into a ring of shared-memory stages guarded by mbarriers, wgmma
// products with f32 accumulation, one producer warp and two consumer
// warpgroups, on a persistent grid.  Hand-written in inline PTX, as
// bf16_mma.cuh is; the kernels and epilogues that use it are in
// lm_head_bf16.cu (the LM head's backward under AMP).  The flash forward
// (flash_attention_bf16.cu) takes its pieces (barriers, TMA, descriptors,
// wgmma with A from shared memory or from registers) for a pipeline of its
// own; the bf16 block's four GEMMs (fused_block_bf16.cu) take the ring,
// its barriers and the operand descriptors, with warpgroups that take
// alternate tiles.
//
// A CTA computes kBM x kBN = 128 x 128 output tiles of A [M, K] . B [K, N]
// over k-tiles of kBK = 64, one tile after another: tile t, t + gridDim.x,
// ... of a static order (Sched), with the grid one CTA per SM.  Its 288
// threads are two consumer warpgroups (warps 0-3 and 4-7: rows 0-63 and
// 64-127 of the tile, one wgmma m64n128k16 per k16 step) and one producer
// warp (warp 8), whose lane 0 issues the TMA loads of every k-tile of the
// CTA's tiles into kStages ring slots.  Slot s has two mbarriers: full[s]
// completes when the producer's arrive.expect_tx and the TMA bytes of both
// operand tiles have landed; empty[s] when the 8 consumer warps have
// finished the wgmma that read it.  So the producer runs up to kStages
// k-tiles ahead, across tile boundaries: the next tile's loads are in
// flight while the consumers run the current tile's epilogue.  Consumers
// keep one wgmma group in flight (wgmma.wait_group 1) and release a slot
// once the group that read it has completed.
//
// Operands.  Each operand is a 2-D bf16 tensor in device memory with rows
// of 16-byte multiples (TMA needs 16-byte strides and a 16-byte-aligned
// base), described by a CUtensorMap with 128-byte swizzle that the host
// builds (tma_maps.cuh; lm_head_bf16.cu: x's and dlogits' for each chunk,
// W's once for each pointer and shape).  Which index is contiguous is a
// template parameter per operand; no operand is copied into another layout:
//   K-major (Op<false>): rows along M (or N), k contiguous.  One TMA box of
//     64 k x 128 rows, stored as 128 rows of 128 bytes; the wgmma
//     descriptor's 8-row groups are 1024 bytes apart (SBO) and a k16 step
//     moves its start 32 bytes along the swizzled row.
//   MN-major (Op<true>, the transpose bits set): rows along k, M (or N)
//     contiguous.  Two TMA boxes of 64 mn x 64 k, 8 KiB apart, each 64 rows
//     of 128 bytes; the descriptor's 64-wide mn blocks are 8192 bytes apart
//     (LBO), its 8-k-row groups 1024 (SBO), and a k16 step moves its start
//     16 rows, 2048 bytes.
// TMA fills the elements outside the tensor with zeros, so any M, N and K
// work; an epilogue masks rows >= M and columns >= N (N a multiple of 8, so
// an 8-wide chunk of a row is wholly inside or outside).
//
// Accumulation.  Each consumer thread holds 64 f32 of its warpgroup's 64 x
// 128 tile: acc[4 j + 2 i + e] is row 16 w + g + 8 i, column 8 j + 2 t + e
// (w the warp in the warpgroup, g = lane / 4, t = lane % 4).  One
// accumulator carries a tile's whole k loop.  gemm_bf16.cuh adds each
// k-tile's products into a second accumulator by f32 adds, since the
// tensor cores may truncate as they accumulate; measured on the card
// (PERF.md, tools/wgmma_flush.py), the bf16 wgmma path holds its compares
// without that.  A build with -DPTT_WG_FLUSH=n (n > 0, that measurement
// only) adds the products into a second accumulator every n k-tiles.
//
// Epilogues stage the tile through shared memory (each warpgroup its own
// 64 x (128 + 8) tile, rows padded so that the fragment writes of a warp
// fall in distinct banks) and write it with 16-byte stores along the rows.
#pragma once

#include <cuda.h>   // CUtensorMap (the types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt_wg {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kTileBytes = kBM * kBK * 2;          // an A or B k-tile
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kEpiLD = kBN + 8;                    // staged row, elements
constexpr int kEpiBytes = 64 * kEpiLD * 4;         // a warpgroup's f32 tile
constexpr int kSmemBytes =
    1024 + kRingBytes + kConsumers * kEpiBytes + 2 * kStages * 8;
// a barrier wait that outlasts this (about 10 s) traps instead of hanging
constexpr long long kWatchdogCycles = 20000000000LL;

#ifndef PTT_WG_FLUSH
#define PTT_WG_FLUSH 0
#endif
constexpr int kFlush = PTT_WG_FLUSH;   // 0: one accumulator (shipped)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits for the phase of parity `parity` of barrier bar to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// box at (c0 along the contiguous index, c1 along rows) of map -> dst,
// completing its bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the box at coordinates (c0 along the contiguous index, c1, c2, c3) of a
// rank-4 map -> dst, completing its bytes on bar
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma, TMA) that follow a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma shared-memory descriptor: start, leading and stride byte
// offsets, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// an operand's k-tile: load (rows from mn0, k from k0) and the descriptor
// of k16 step j for the 64 (r0 = 0 or 64) or 128 (r0 = 0) rows from r0
template <bool MN>
struct Op;

template <>
struct Op<false> {   // K-major: [128 rows][64 k], one box
  static __device__ __forceinline__ void load(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int mn0, int k0) {
    tma_load(dst, map, bar, k0, mn0);
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t tile, int r0,
                                                  int j) {
    return make_desc(tile + r0 * 128 + j * 32, 16, 1024);
  }
};

template <>
struct Op<true> {   // MN-major: [2][64 k][64 mn], two boxes
  static __device__ __forceinline__ void load(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int mn0, int k0) {
    tma_load(dst, map, bar, mn0, k0);
    tma_load(dst + kTileBytes / 2, map, bar, mn0 + 64, k0);
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t tile, int r0,
                                                  int j) {
    return make_desc(tile + r0 / 64 * (kTileBytes / 2) + j * 2048,
                     kTileBytes / 2, 1024);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of d above a wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B over one k16 step, A 64 x 16 and B 16 x 128 from shared
// memory; scale_d 0 overwrites d; TA, TB: the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#define PTT_WG_ACC8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PTT_WG_ACC32 \
  PTT_WG_ACC8(0), PTT_WG_ACC8(8), PTT_WG_ACC8(16), PTT_WG_ACC8(24)
#define PTT_WG_REGS32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A . B over one k16 step, A 64 x 16 and B 16 x 64 from shared
// memory: wgmma<TA, TB>'s m64n64k16, 32 accumulators a thread
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_WG_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : PTT_WG_ACC32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A . B over one k16 step, A 64 x 16 from registers (a: the
// m16n8k16 A fragment of the warp's 16 rows, which is the accumulator of
// a wgmma packed pairwise to bf16) and B 16 x N from shared memory; N 64
// or 128 (N / 2 accumulators a thread); TB: B is N-major
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : PTT_WG_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : PTT_WG_ACC32, PTT_WG_ACC8(32), PTT_WG_ACC8(40), PTT_WG_ACC8(48),
        PTT_WG_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// the m64nNk16 product with both operands in shared memory, N the
// accumulator count times 2
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma<TA, TB>(d, da, db, scale_d);
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma64<TA, TB>(d, da, db, scale_d);
}

// The static tile order: tile t is (m, n, range) with m fastest, so the
// CTAs that run at one time share B's column tiles; range r covers k-tiles
// [r kct, min(nk, (r + 1) kct)).
struct Sched {
  int mt, nt, ranges, nk, kct;
  __host__ __device__ int tiles() const { return mt * nt * ranges; }
  __device__ __forceinline__ void tile(int t, int& m0, int& n0, int& r,
                                       int& kb, int& ke) const {
    m0 = t % mt * kBM;
    t /= mt;
    n0 = t % nt * kBN;
    r = t / nt;
    kb = r * kct;
    ke = min(nk, kb + kct);
  }
};

inline int cdiv_(long long a, long long b) { return (int)((a + b - 1) / b); }

// the order of A [M, K] . B [K, N] with K cut into `ranges` ranges (as
// many as ranges of cdiv(k-tiles, ranges) k-tiles need)
inline Sched sched(int M, int N, int K, int ranges) {
  Sched s;
  s.mt = cdiv_(M, kBM);
  s.nt = cdiv_(N, kBN);
  s.nk = cdiv_(K, kBK);
  s.kct = cdiv_(s.nk, ranges);
  s.ranges = cdiv_(s.nk, s.kct);
  return s;
}

// The CTA's shared memory: the ring (1024-aligned, as the 128-byte swizzle
// needs), the consumers' staging tiles, the barriers.
struct Smem {
  uint32_t ring, bars;
  uint8_t* epi;
  __device__ __forceinline__ uint32_t a(int s) const {
    return ring + s * kStageBytes;
  }
  __device__ __forceinline__ uint32_t b(int s) const {
    return a(s) + kTileBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return bars + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (kStages + s);
  }
};

// lays out the dynamic shared memory (kSmemBytes) and initialises the
// barriers; every thread of the CTA calls it once, first.  readers: the
// warps that read each slot and arrive on its empty barrier (all consumer
// warps, or one warpgroup's where the warpgroups take alternate tiles)
__device__ __forceinline__ Smem setup(uint8_t* raw,
                                      int readers = 4 * kConsumers) {
  const uint32_t base = smem_addr(raw);
  const uint32_t pad = (1024 - base % 1024) % 1024;
  Smem s;
  s.ring = base + pad;
  s.epi = raw + pad + kRingBytes;
  s.bars = s.ring + kRingBytes + kConsumers * kEpiBytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(s.full(i), 1);
      mbar_init(s.empty(i), readers);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return s;
}

// A ring position: slot and the parity of its current pass (of a ring of
// n stages).
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int n = kStages) {
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer (one thread): every k-tile of the CTA's tiles, in order.
template <bool AMN, bool BMN>
__device__ __forceinline__ void produce(const CUtensorMap* ta,
                                        const CUtensorMap* tb, const Smem& sm,
                                        const Sched& s) {
  Pipe p;
  for (int t = blockIdx.x; t < s.tiles(); t += gridDim.x) {
    int m0, n0, r, kb, ke;
    s.tile(t, m0, n0, r, kb, ke);
    for (int k = kb; k < ke; ++k) {
      mbar_wait(sm.empty(p.stage), p.phase ^ 1);
      mbar_expect_tx(sm.full(p.stage), kStageBytes);
      Op<AMN>::load(sm.a(p.stage), ta, sm.full(p.stage), m0, k * kBK);
      Op<BMN>::load(sm.b(p.stage), tb, sm.full(p.stage), n0, k * kBK);
      p.next();
    }
  }
}

__device__ __forceinline__ void release(uint32_t empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// issues the products of the k-tile in the current slot once it has
// landed: kBK / 16 wgmma into d, the first overwriting d where fresh
template <bool AMN, bool BMN>
__device__ __forceinline__ void ktile(float (&d)[64], const Smem& sm,
                                      const Pipe& p, int h, bool fresh) {
  mbar_wait(sm.full(p.stage), p.phase);
  wgmma_fence();
  const uint32_t sa = sm.a(p.stage), sb = sm.b(p.stage);
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wgmma<AMN, BMN>(d, Op<AMN>::desc(sa, 64 * h, j), Op<BMN>::desc(sb, 0, j),
                    fresh && j == 0 ? 0 : 1);
  wgmma_commit();
}

// A consumer warpgroup (h: rows 64 h ..) over k-tiles [kb, ke) (at least
// one) of one output tile: acc = its 64 x 128 products.  The last k-tile is
// peeled off the loop, so that no read of the accumulators sits under a
// branch: ptxas serializes every wgmma of a kernel that has one (C7518).
// kFlush > 0 (a measurement build, whose flush branch is such a read): the
// products go into part and are added to acc every kFlush k-tiles and at
// the end.
template <bool AMN, bool BMN>
__device__ __forceinline__ void mainloop(float (&acc)[64], const Smem& sm,
                                         Pipe& p, int h, int kb, int ke) {
  float part[64];
  float(&d)[64] = kFlush > 0 ? part : acc;
  if (kFlush > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }
  bool fresh = true;   // the next product overwrites d
  int held = -1;       // a slot whose products may still be in flight
  for (int k = kb; k + 1 < ke; ++k) {
    ktile<AMN, BMN>(d, sm, p, h, fresh);
    fresh = false;
    if (kFlush > 0 && (k - kb + 1) % (kFlush > 0 ? kFlush : 1) == 0) {
      wgmma_wait<0>();
      fence_acc(d);
      if (held >= 0) release(sm.empty(held));
      release(sm.empty(p.stage));
      held = -1;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
      fresh = true;
    } else {
      wgmma_wait<1>();   // the previous k-tile's group is done
      if (held >= 0) release(sm.empty(held));
      held = p.stage;
    }
    p.next();
  }
  ktile<AMN, BMN>(d, sm, p, h, fresh);
  wgmma_wait<0>();
  fence_acc(d);
  if (held >= 0) release(sm.empty(held));
  release(sm.empty(p.stage));
  p.next();
  if (kFlush > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  }
}

// the consumer warpgroups' barrier (named barrier 1 + h, 128 threads)
__device__ __forceinline__ void wg_sync(int h) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(h + 1) : "memory");
}

}  // namespace ptt_wg
