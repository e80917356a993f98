// Matrix product C = A @ B for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gemm.py:_gemm_kernel
// (called by `gemm`, pallas_call at gemm.py:67).  Every offloaded level-3
// BLAS routine of the port reaches it through kernels/ops.py:matmul, the
// complex ones as four real products (4M), the update step of the trsm
// recursion calls it directly, and every projection of the LM stack runs
// on it.
//
// What bounds it on an H100 depends on the type and on M: a large product
// (the LSMS plane, 6912^3 in float64: ~576 operations per byte; a prefill
// projection, 9216 x 3584 x 14336 in bf16: ~1.5e4) is bound by the
// arithmetic units of its type, a decode projection (M = 2) by the bytes
// of B.  The TPU kernel is one (bm, bk, bn) tiling for every type and
// shape: the MXU takes them all.  Design: here the types reach different
// units, so the wrapper (kernels/gemm.py, `plan`) picks one of four paths
// and passes it here:
//
// 1. bf16/f16, M >= 64 (the prefill projections and vocab head): bound by
//    operations (the tensor cores' line is ~295 per byte).  wgmma on 128 x
//    BN x 64 tiles (BN 256 by default), fed by TMA into a 4-stage ring of
//    128-byte-swizzled shared memory guarded by mbarriers: one producer
//    thread issues the loads, two consumer warpgroups (64 rows each) issue
//    wgmma and keep one group in flight.  fp32 accumulators; the epilogue masks the ragged edge and
//    writes the output type.  TMA zero-fills loads past the edges.  Either
//    operand may be K-major or MN-major (a transposed view), which wgmma
//    reads through its transpose bits, so no operand is copied.  Tiles go
//    out in groups of 8 row-tiles, so the blocks of one wave share their
//    A and B tiles in L2.  TMA needs 16-byte aligned bases and row strides;
//    operands that are not go to path 2 at any M.
// 2. bf16/f16, M < 64 (every decode projection, M = 2): bound by the bytes
//    of B.  A, at most 64 rows, is staged in shared memory as float a chunk
//    of K at a time; B streams once through registers with 16-byte loads,
//    never through shared memory.  A row-major B (weights [K, N]) is read
//    as strips of 128 columns by 16 k-lanes, each thread 8 columns; a
//    K-contiguous B (the tied table's transposed view) is read as dot
//    products, a warp per 4 columns with its lanes along K.  Where the
//    strips leave SMs idle (the 2048-wide k/v projections), K is split
//    across blocks and a second launch sums the fp32 partials in a fixed
//    order: no atomics, the same bits run to run.  Rows go in groups of
//    1, 2, 4 or 8, side by side on the grid.
// 3. float64: DMMA (mma.sync m16n8k4 f64) on 128 x 128 x 32 tiles, 8 warps
//    of 64 x 32, with a 3-stage cp.async pipeline and fp64 accumulators;
//    each operand is staged in the layout it has in device memory.
// 4. float32: IEEE fmaf on the FMA units (the reference's accumulation
//    rule; TF32 would miss its tolerance and the split bounds), 128 x 128 x
//    16 tiles with 8 x 8 per thread and a 3-stage cp.async pipeline, 16-byte
//    copies where the operand is contiguous along the tile's rows.
//
// Paths 1, 3 and 4 compile two or three tile edges (OffloadConfig.
// kernel_block picks one, kernels/gemm.py:EDGES); path 2 has none.
// Operands are given as [MN, K] views with element strides, so row-major,
// transposed and row-strided views all go in uncopied; batches run on the
// grid's last axis.
#include "hopper.cuh"

namespace {

// dtype codes shared with kernels/gemm.py
enum Code { F32 = 0, F64 = 1, BF16 = 2, F16 = 3 };
// paths, as kernels/gemm.py:plan numbers them
enum Path { TC = 1, SKINNY = 2, DMMA = 3, SIMT = 4 };

// One operand as a logical [MN, K] matrix per batch: element (mn, k) of
// batch z is p[z * sb + mn * smn + k * sk].
struct Op {
    const void* p;
    long long smn, sk, sb;
};

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

// element i of an output of type out_code
__device__ __forceinline__ void store_code(void* c, long long i, int out_code, float v) {
    if (out_code == BF16) store(static_cast<__nv_bfloat16*>(c) + i, v);
    else if (out_code == F16) store(static_cast<__half*>(c) + i, v);
    else store(static_cast<float*>(c) + i, v);
}

// ---------------------------------------------------------------------------
// cp.async (paths 3 and 4)
// ---------------------------------------------------------------------------
// Copy BYTES from global to shared memory, or zero-fill them when !valid
// (src-size 0: nothing is read, src only has to be a mapped address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    const int n = valid ? BYTES : 0;
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(saddr(dst)), "l"(src), "r"(n) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(saddr(dst)), "l"(src), "n"(BYTES), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage the BT x BK tile at (mn0, k0) of one operand k-major into shared
// memory, s[k * LDS + mn], zero outside the matrix.  `vec`: the operand is
// contiguous along MN with 16-byte aligned base and strides, so whole
// 16-byte runs are copied; otherwise one element per copy, neighbouring
// threads on neighbouring addresses of whichever dimension is contiguous.
template <typename T, int BT, int BK, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long smn, long long sk,
                                          int MN, int K, int mn0, int k0, int tid, bool vec) {
    constexpr int V = 16 / sizeof(T);
    if (vec) {
#pragma unroll
        for (int e = tid; e < BT * BK / V; e += THREADS) {
            const int k = e / (BT / V), mn = (e % (BT / V)) * V;
            const int gk = k0 + k, gm = mn0 + mn;
            T* dst = s + k * LDS + mn;
            if (gk < K && gm + V <= MN) {
                cp_async<16>(dst, g + static_cast<long long>(gk) * sk + gm, true);
            } else {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    const bool ok = gk < K && gm + v < MN;
                    cp_async<sizeof(T)>(dst + v, ok ? g + static_cast<long long>(gk) * sk + gm + v : g, ok);
                }
            }
        }
    } else if (sk == 1) {
#pragma unroll
        for (int e = tid; e < BT * BK; e += THREADS) {
            const int k = e % BK, mn = e / BK;
            const int gk = k0 + k, gm = mn0 + mn;
            const bool ok = gk < K && gm < MN;
            cp_async<sizeof(T)>(s + k * LDS + mn, ok ? g + static_cast<long long>(gm) * smn + gk : g, ok);
        }
    } else {
#pragma unroll
        for (int e = tid; e < BT * BK; e += THREADS) {
            const int mn = e % BT, k = e / BT;
            const int gk = k0 + k, gm = mn0 + mn;
            const bool ok = gk < K && gm < MN;
            cp_async<sizeof(T)>(s + k * LDS + mn,
                                ok ? g + static_cast<long long>(gm) * smn + static_cast<long long>(gk) * sk : g, ok);
        }
    }
}

constexpr int PIPE_THREADS = 256;
constexpr int PIPE_BK = 16;
constexpr int PIPE_STAGES = 3;

template <typename T, int BT>
__host__ __device__ constexpr int pipe_lds() { return BT + (sizeof(T) == 8 ? 8 : 4); }
template <typename T, int BT>
__host__ __device__ constexpr int pipe_smem() { return PIPE_STAGES * 2 * PIPE_BK * pipe_lds<T, BT>() * sizeof(T); }

// ---------------------------------------------------------------------------
// Path 4: float32 on the FMA units
// ---------------------------------------------------------------------------
// Thread (ty, tx) of 16 x 16 owns rows h*64 + ty*4 + i and columns
// g*64 + tx*4 + j (h, g < BT/64, i, j < 4): float4 reads of shared memory,
// a warp's B reads 256 contiguous bytes and its A reads two broadcasts.
template <int BT>
__global__ void __launch_bounds__(PIPE_THREADS)
simt_f32_kernel(Op A, Op B, float* __restrict__ C, int M, int N, int K,
                long long ldc, long long sc, int va, int vb) {
    constexpr int BK = PIPE_BK, S = PIPE_STAGES, LDS = pipe_lds<float, BT>();
    constexpr int TM = BT / 16, H = TM / 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* As = reinterpret_cast<float*>(smem_raw);
    float* Bs = As + S * BK * LDS;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT, z = blockIdx.z;
    const float* ga = static_cast<const float*>(A.p) + z * A.sb;
    const float* gb = static_cast<const float*>(B.p) + z * B.sb;
    const int KT = (K + BK - 1) / BK;

    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

    auto load = [&](int t) {
        const int st = t % S;
        load_tile<float, BT, BK, LDS, PIPE_THREADS>(As + st * BK * LDS, ga, A.smn, A.sk, M, K, m0, t * BK, tid, va);
        load_tile<float, BT, BK, LDS, PIPE_THREADS>(Bs + st * BK * LDS, gb, B.smn, B.sk, N, K, n0, t * BK, tid, vb);
    };
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
        if (t < KT) load(t);
        cp_commit();
    }
    for (int t = 0; t < KT; ++t) {
        cp_wait<S - 2>();
        __syncthreads();
        if (t + S - 1 < KT) load(t + S - 1);
        cp_commit();
        const float* as = As + (t % S) * BK * LDS;
        const float* bs = Bs + (t % S) * BK * LDS;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], b[TM];
#pragma unroll
            for (int h = 0; h < H; ++h) {
                const float4 x = *reinterpret_cast<const float4*>(as + kk * LDS + h * 64 + ty * 4);
                const float4 y = *reinterpret_cast<const float4*>(bs + kk * LDS + h * 64 + tx * 4);
                a[4 * h] = x.x; a[4 * h + 1] = x.y; a[4 * h + 2] = x.z; a[4 * h + 3] = x.w;
                b[4 * h] = y.x; b[4 * h + 1] = y.y; b[4 * h + 2] = y.z; b[4 * h + 3] = y.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
    cp_wait<0>();

    C += z * sc;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = m0 + (i / 4) * 64 + ty * 4 + i % 4;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
            const int c = n0 + (j / 4) * 64 + tx * 4 + j % 4;
            if (c < N) C[static_cast<long long>(r) * ldc + c] = acc[i][j];
        }
    }
}

// ---------------------------------------------------------------------------
// Path 3: float64 on the DMMA tensor cores
// ---------------------------------------------------------------------------
// m16n8k4: the shape that reaches the full fp64 tensor rate on sm_90;
// m8n8k4 issues at half of it there
__device__ __forceinline__ void dmma(double* c, double a0, double a1, double b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a0), "d"(a1), "d"(b));
}

constexpr int DMMA_BK = 32;
constexpr int DMMA_STAGES = 3;
constexpr int DMMA_LDK = DMMA_BK + 4;    // [mn][k] rows of 288 bytes

// elements of one operand tile in either shared layout
template <int BT>
__host__ __device__ constexpr int dmma_tile() {
    return BT * DMMA_LDK > DMMA_BK * pipe_lds<double, BT>() ? BT * DMMA_LDK
                                                          : DMMA_BK * pipe_lds<double, BT>();
}
template <int BT>
__host__ __device__ constexpr int dmma_smem() { return DMMA_STAGES * 2 * dmma_tile<BT>() * 8; }

// Stage the BT x BK tile at (mn0, k0) of a K-contiguous operand as it lies,
// s[mn * LDK + k], zero outside the matrix.  `vec`: 16-byte aligned base
// and strides, so pairs of k are copied at once.
template <int BT, int BK, int LDK, int THREADS>
__device__ __forceinline__ void load_tile_km(double* s, const double* g, long long smn, long long sk,
                                             int MN, int K, int mn0, int k0, int tid, bool vec) {
    if (vec) {
#pragma unroll
        for (int e = tid; e < BT * BK / 2; e += THREADS) {
            const int mn = e / (BK / 2), k = (e % (BK / 2)) * 2;
            const int gm = mn0 + mn, gk = k0 + k;
            double* dst = s + mn * LDK + k;
            const double* src = g + static_cast<long long>(gm) * smn + gk;
            if (gm < MN && gk + 2 <= K) {
                cp_async<16>(dst, src, true);
            } else {
                const bool ok0 = gm < MN && gk < K, ok1 = gm < MN && gk + 1 < K;
                cp_async<8>(dst, ok0 ? src : g, ok0);
                cp_async<8>(dst + 1, ok1 ? src + 1 : g, ok1);
            }
        }
    } else {
#pragma unroll
        for (int e = tid; e < BT * BK; e += THREADS) {
            const int mn = e / BK, k = e % BK;
            const int gm = mn0 + mn, gk = k0 + k;
            const bool ok = gm < MN && gk < K;
            cp_async<8>(s + mn * LDK + k,
                        ok ? g + static_cast<long long>(gm) * smn + static_cast<long long>(gk) * sk : g, ok);
        }
    }
}

// 8 warps as 2 x 4, each a (BT/2) x (BT/4) block of 16 x 8 mma tiles.  The
// fragments of m16n8k4 (g = l/4, t = l%4 for lane l): A[g][t] and
// A[g+8][t], B[t][g], and C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
// Each operand is staged in the layout it has in device memory, so every
// copy moves contiguous bytes: K-contiguous ([mn][k], AKM / BKM) in rows
// of 36 doubles, MN-contiguous ([k][mn]) in rows of BT + 8.  Either
// padding puts a fragment read's eight 32-byte pieces (or four 64-byte
// ones) in two wavefronts, the least 256 bytes take.  A 3-stage cp.async
// ring of 32-deep K tiles (216 KB at BT 128) keeps two in flight.
template <int BT, bool AKM, bool BKM>
__global__ void __launch_bounds__(PIPE_THREADS)
dmma_f64_kernel(Op A, Op B, double* __restrict__ C, int M, int N, int K,
                long long ldc, long long sc, int va, int vb) {
    constexpr int BK = DMMA_BK, S = DMMA_STAGES, LDS = pipe_lds<double, BT>();
    constexpr int LDK = DMMA_LDK, TILE = dmma_tile<BT>();
    constexpr int WM = BT / 2, WN = BT / 4, MT = WM / 16, NT = WN / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* As = reinterpret_cast<double*>(smem_raw);
    double* Bs = As + S * TILE;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm0 = (warp / 4) * WM, wn0 = (warp % 4) * WN;
    const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT, z = blockIdx.z;
    const double* ga = static_cast<const double*>(A.p) + z * A.sb;
    const double* gb = static_cast<const double*>(B.p) + z * B.sb;
    const int KT = (K + BK - 1) / BK;

    double acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;

    auto load = [&](int t) {
        double* as = As + (t % S) * TILE;
        double* bs = Bs + (t % S) * TILE;
        if constexpr (AKM)
            load_tile_km<BT, BK, LDK, PIPE_THREADS>(as, ga, A.smn, A.sk, M, K, m0, t * BK, tid, va);
        else
            load_tile<double, BT, BK, LDS, PIPE_THREADS>(as, ga, A.smn, A.sk, M, K, m0, t * BK, tid, va);
        if constexpr (BKM)
            load_tile_km<BT, BK, LDK, PIPE_THREADS>(bs, gb, B.smn, B.sk, N, K, n0, t * BK, tid, vb);
        else
            load_tile<double, BT, BK, LDS, PIPE_THREADS>(bs, gb, B.smn, B.sk, N, K, n0, t * BK, tid, vb);
    };
    // element (mn, k) of a staged tile
    auto at_a = [&](const double* s, int mn, int k) { return AKM ? s[mn * LDK + k] : s[k * LDS + mn]; };
    auto at_b = [&](const double* s, int mn, int k) { return BKM ? s[mn * LDK + k] : s[k * LDS + mn]; };
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
        if (t < KT) load(t);
        cp_commit();
    }
    for (int t = 0; t < KT; ++t) {
        cp_wait<S - 2>();
        __syncthreads();
        if (t + S - 1 < KT) load(t + S - 1);
        cp_commit();
        const double* as = As + (t % S) * TILE;
        const double* bs = Bs + (t % S) * TILE;
#pragma unroll
        for (int kq = 0; kq < BK / 4; ++kq) {
            const int k = kq * 4 + t4;
            double a[MT][2], b[NT];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                a[i][0] = at_a(as, wm0 + i * 16 + g, k);
                a[i][1] = at_a(as, wm0 + i * 16 + 8 + g, k);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) b[j] = at_b(bs, wn0 + j * 8 + g, k);
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j) dmma(acc[i][j], a[i][0], a[i][1], b[j]);
        }
    }
    cp_wait<0>();

    C += z * sc;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm0 + i * 16 + h * 8 + g;
            if (r >= M) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int c = n0 + wn0 + j * 8 + 2 * t4;
                if (c < N) C[static_cast<long long>(r) * ldc + c] = acc[i][j][2 * h];
                if (c + 1 < N) C[static_cast<long long>(r) * ldc + c + 1] = acc[i][j][2 * h + 1];
            }
        }
}

// ---------------------------------------------------------------------------
// Path 1: bf16/f16 on the tensor cores, wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int TC_BM = 128;       // two consumer warpgroups of 64 rows
constexpr int TC_BK = 64;        // 128 bytes of K: one swizzle row
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 384;  // consumers 0-255, producer warpgroup 256-383
constexpr int TC_GROUP = 8;      // row-tiles per raster group

template <int BN>
__host__ __device__ constexpr int tc_stage_bytes() { return (TC_BM + BN) * TC_BK * 2; }
template <int BN>
__host__ __device__ constexpr int tc_smem() { return TC_STAGES * tc_stage_bytes<BN>() + 1024 + 2 * TC_STAGES * 8; }

// The consumers' main loop for one pair of operand majors (TA / TB 0:
// K-major, 1: MN-major), chosen once per launch so that no branch sits
// between the asynchronous wgmma of a k-tile.
template <typename T, int BN, int TA, int TB>
__device__ __forceinline__ void tc_mainloop(float* acc, unsigned char* base, uint64_t* full,
                                            uint64_t* empty, int KT, int wg) {
    constexpr int A_BYTES = TC_BM * TC_BK * 2;
    constexpr int STAGE = tc_stage_bytes<BN>();
    for (int i = 0; i < KT; ++i) {
        const int s = i % TC_STAGES;
        mbar_wait(&full[s], (i / TC_STAGES) & 1);
        const uint32_t sa = saddr(base + s * STAGE) + wg * 8192;
        const uint32_t sb = saddr(base + s * STAGE + A_BYTES);
        fence_regs<BN / 2>(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
            const uint64_t da = make_desc(sa + (TA == 0 ? kk * 32 : kk * 2048), TA == 0);
            const uint64_t db = make_desc(sb + (TB == 0 ? kk * 32 : kk * 2048), TB == 0);
            wgmma_tile<T, BN, TA, TB>(acc, da, db);
        }
        wg_commit();
        fence_regs<BN / 2>(acc);
        wg_wait<1>();          // the group of k-tile i - 1 is done with its stage
        if (i > 0) mbar_arrive(&empty[(i - 1) % TC_STAGES]);
    }
    wg_wait<0>();
    fence_regs<BN / 2>(acc);
}

// The fp32 accumulator of consumer warpgroup wg: lane l of warp w holds, for
// each 8-column group j, rows w*16 + l/4 (+8) and columns 8j + 2(l%4) (+1).
template <typename OutT, int BN>
__device__ __forceinline__ void tc_store(OutT* C, const float* acc, int M, int N, long long ldc,
                                         int m0, int n0, int wg, int tid) {
    const int w = (tid % 128) / 32, lane = tid % 32;
    const int r0 = m0 + wg * 64 + w * 16 + lane / 4;
    const int cb = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        const int c = cb + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r < M) {
                if (c < N) store(C + static_cast<long long>(r) * ldc + c, acc[4 * j + 2 * h]);
                if (c + 1 < N) store(C + static_cast<long long>(r) * ldc + c + 1, acc[4 * j + 2 * h + 1]);
            }
        }
    }
}

template <typename T, int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          void* C, int out_code, int M, int N, int K, long long ldc, long long sc,
          int a_kmajor, int b_kmajor) {
    constexpr int A_BYTES = TC_BM * TC_BK * 2;
    constexpr int STAGE = tc_stage_bytes<BN>();
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(base + TC_STAGES * STAGE);
    uint64_t* empty = full + TC_STAGES;

    const int tid = threadIdx.x, wg = tid / 128;
    const int tiles_m = (M + TC_BM - 1) / TC_BM, tiles_n = (N + BN - 1) / BN;
    const int per_group = TC_GROUP * tiles_n;
    const int lin = blockIdx.x;
    const int first_m = (lin / per_group) * TC_GROUP;
    const int gsize = min(tiles_m - first_m, TC_GROUP);
    const int m0 = (first_m + (lin % per_group) % gsize) * TC_BM;
    const int n0 = ((lin % per_group) / gsize) * BN;
    const int z = blockIdx.y;
    const int KT = (K + TC_BK - 1) / TC_BK;

    if (tid == 0) {
        for (int s = 0; s < TC_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 2) {
        // producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == 256) {
            for (int i = 0; i < KT; ++i) {
                const int s = i % TC_STAGES;
                if (i >= TC_STAGES) mbar_wait(&empty[s], ((i / TC_STAGES) - 1) & 1);
                unsigned char* sa = base + s * STAGE;
                unsigned char* sb = sa + A_BYTES;
                mbar_expect_tx(&full[s], STAGE);
                const int k0 = i * TC_BK;
                if (a_kmajor) {
                    tma_load(sa, &map_a, &full[s], k0, m0, z);
                } else {
                    tma_load(sa, &map_a, &full[s], m0, k0, z);
                    tma_load(sa + 8192, &map_a, &full[s], m0 + 64, k0, z);
                }
                if (b_kmajor) {
                    tma_load(sb, &map_b, &full[s], k0, n0, z);
                } else {
#pragma unroll
                    for (int j = 0; j < BN / 64; ++j)
                        tma_load(sb + j * 8192, &map_b, &full[s], n0 + 64 * j, k0, z);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        float acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        if (a_kmajor) {
            if (b_kmajor) tc_mainloop<T, BN, 0, 0>(acc, base, full, empty, KT, wg);
            else tc_mainloop<T, BN, 0, 1>(acc, base, full, empty, KT, wg);
        } else {
            if (b_kmajor) tc_mainloop<T, BN, 1, 0>(acc, base, full, empty, KT, wg);
            else tc_mainloop<T, BN, 1, 1>(acc, base, full, empty, KT, wg);
        }
        const long long off = static_cast<long long>(z) * sc;
        if (out_code == F32)
            tc_store<float, BN>(static_cast<float*>(C) + off, acc, M, N, ldc, m0, n0, wg, tid);
        else
            tc_store<T, BN>(static_cast<T*>(C) + off, acc, M, N, ldc, m0, n0, wg, tid);
    }
}

// ---------------------------------------------------------------------------
// Path 2: bf16/f16 with few rows, bound by the bytes of B
// ---------------------------------------------------------------------------
constexpr int SK_THREADS = 256;

// 8 consecutive elements (stride 1) from p, `valid` of them in bounds; one
// 16-byte load where allowed
template <typename T>
__device__ __forceinline__ void load8(const T* p, int valid, bool vec, float* o) {
    if (vec && valid >= 8) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
        const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int v = 0; v < 8; ++v) o[v] = to_f(h[v]);
    } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) o[v] = v < valid ? to_f(p[v]) : 0.f;
    }
}

// K range of split `s` of `splits`: whole 64-element runs
__device__ __forceinline__ void split_range(int K, int splits, int s, int& kb, int& ke) {
    const int kper = ((K + splits - 1) / splits + 63) / 64 * 64;
    kb = min(K, s * kper);
    ke = min(K, kb + kper);
}

// rows r0 .. r0 + MR of A, columns c0 .. c0 + clen, as float into sA
template <typename T, int MR, int KC>
__device__ __forceinline__ void stage_a(float (*sA)[KC], const T* ga, const Op& A, int M, int r0,
                                        int c0, int clen, int tid) {
    for (int e = tid; e < MR * KC; e += SK_THREADS) {
        const int r = e / KC, k = e % KC;
        float v = 0.f;
        if (r0 + r < M && k < clen)
            v = to_f(ga[static_cast<long long>(r0 + r) * A.smn + static_cast<long long>(c0 + k) * A.sk]);
        sA[r][k] = v;
    }
}

// write one finished element: the output, or this split's partial
__device__ __forceinline__ void skinny_out(void* C, float* W, int out_code, int splits, int split,
                                           int z, int batch, int M, int N, long long ldc, long long sc,
                                           int row, int col, float v) {
    if (splits == 1)
        store_code(C, static_cast<long long>(z) * sc + static_cast<long long>(row) * ldc + col, out_code, v);
    else
        W[((static_cast<long long>(split) * batch + z) * M + row) * N + col] = v;
}

// B row-major (B[k][n] at k * sk + n): strips of 128 columns; thread
// (kl, cg) of 16 x 16 takes columns cg*8 .. +8 at k = kl, kl + 16, ...
template <typename T, int MR>
__global__ void __launch_bounds__(SK_THREADS)
skinny_strip_kernel(Op A, Op B, void* C, float* W, int out_code, int M, int N, int K,
                    long long ldc, long long sc, int splits, int vec) {
    constexpr int KC = 4096 / MR;
    __shared__ __align__(16) float sA[MR][KC];
    __shared__ float red[16][129];
    const int tid = threadIdx.x, cg = tid % 16, kl = tid / 16;
    // blockIdx.y: the K split (fastest) and the first group of MR rows
    const int split = blockIdx.y % splits, z = blockIdx.z, batch = gridDim.z;
    const int row_step = gridDim.y / splits * MR;
    const int n0 = blockIdx.x * 128 + cg * 8;
    const int nvalid = min(8, N - n0);
    const T* ga = static_cast<const T*>(A.p) + z * A.sb;
    const T* gb = static_cast<const T*>(B.p) + z * B.sb;
    int kb, ke;
    split_range(K, splits, split, kb, ke);
    for (int r0 = blockIdx.y / splits * MR; r0 < M; r0 += row_step) {
        float acc[MR][8];
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
        for (int c0 = kb; c0 < ke; c0 += KC) {
            const int clen = min(KC, ke - c0);
            __syncthreads();
            stage_a<T, MR, KC>(sA, ga, A, M, r0, c0, clen, tid);
            __syncthreads();
            if (nvalid > 0) {
                const T* bp = gb + static_cast<long long>(c0) * B.sk + n0;
#pragma unroll 4
                for (int k = kl; k < clen; k += 16) {
                    float b[8];
                    load8(bp + static_cast<long long>(k) * B.sk, nvalid, vec, b);
#pragma unroll
                    for (int r = 0; r < MR; ++r) {
                        const float a = sA[r][k];
#pragma unroll
                        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a, b[j], acc[r][j]);
                    }
                }
            }
        }
        // the 16 k-lanes of a column, summed in a fixed order
#pragma unroll
        for (int r = 0; r < MR; ++r) {
            __syncthreads();
#pragma unroll
            for (int j = 0; j < 8; ++j) red[kl][cg * 8 + j] = acc[r][j];
            __syncthreads();
            if (tid < 128) {
                float s = 0.f;
#pragma unroll
                for (int q = 0; q < 16; ++q) s += red[q][tid];
                const int row = r0 + r, col = blockIdx.x * 128 + tid;
                if (row < M && col < N)
                    skinny_out(C, W, out_code, splits, split, z, batch, M, N, ldc, sc, row, col, s);
            }
        }
    }
}

// B K-contiguous (B[k][n] at n * smn + k, e.g. a transposed table): each
// warp takes 4 columns, its lanes 8 consecutive k each, 256 k per step
template <typename T, int MR>
__global__ void __launch_bounds__(SK_THREADS)
skinny_dot_kernel(Op A, Op B, void* C, float* W, int out_code, int M, int N, int K,
                  long long ldc, long long sc, int splits, int vec) {
    constexpr int KC = 4096 / MR, CW = 4;
    __shared__ __align__(16) float sA[MR][KC];
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    // blockIdx.y: the K split (fastest) and the first group of MR rows
    const int split = blockIdx.y % splits, z = blockIdx.z, batch = gridDim.z;
    const int row_step = gridDim.y / splits * MR;
    const int nb = blockIdx.x * (8 * CW) + warp * CW;
    const T* ga = static_cast<const T*>(A.p) + z * A.sb;
    const T* gb = static_cast<const T*>(B.p) + z * B.sb;
    int kb, ke;
    split_range(K, splits, split, kb, ke);
    for (int r0 = blockIdx.y / splits * MR; r0 < M; r0 += row_step) {
        float acc[MR][CW];
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
        for (int c0 = kb; c0 < ke; c0 += KC) {
            const int clen = min(KC, ke - c0);
            __syncthreads();
            stage_a<T, MR, KC>(sA, ga, A, M, r0, c0, clen, tid);
            __syncthreads();
#pragma unroll 2
            for (int k = lane * 8; k < clen; k += 256) {
                const int kv = min(8, clen - k);
                float b[CW][8];
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                    if (nb + c < N)
                        load8(gb + static_cast<long long>(nb + c) * B.smn + c0 + k, kv, vec, b[c]);
                    else
#pragma unroll
                        for (int v = 0; v < 8; ++v) b[c][v] = 0.f;
                }
#pragma unroll
                for (int r = 0; r < MR; ++r) {
                    const float4 x = *reinterpret_cast<const float4*>(&sA[r][k]);
                    const float4 y = *reinterpret_cast<const float4*>(&sA[r][k + 4]);
                    const float a[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
                    for (int c = 0; c < CW; ++c)
#pragma unroll
                        for (int v = 0; v < 8; ++v) acc[r][c] = fmaf(a[v], b[c][v], acc[r][c]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
            for (int c = 0; c < CW; ++c) {
                float v = acc[r][c];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
                const int row = r0 + r, col = nb + c;
                if (lane == 0 && row < M && col < N)
                    skinny_out(C, W, out_code, splits, split, z, batch, M, N, ldc, sc, row, col, v);
            }
    }
}

// C = sum over splits of the fp32 partials, in split order
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ W, void* C, int out_code, int M, int N, int batch,
                     int splits, long long ldc, long long sc) {
    const long long mn = static_cast<long long>(M) * N;
    const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    if (i >= mn * batch) return;
    const int z = static_cast<int>(i / mn);
    const long long e = i % mn;
    const int row = static_cast<int>(e / N), col = static_cast<int>(e % N);
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += W[(static_cast<long long>(q) * batch + z) * mn + e];
    store_code(C, static_cast<long long>(z) * sc + static_cast<long long>(row) * ldc + col, out_code, s);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// a 3-D map (inner, outer, batch) of 16-bit elements, 128-byte swizzle
bool make_map(CUtensorMap* map, int code, const void* p, long long inner, long long outer,
              long long batch, long long ld, long long sb, int box_inner, int box_outer) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2, static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUtensorMapDataType dt = code == BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    return fn(map, dt, 3, const_cast<void*>(p), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
int set_smem(K kernel, int bytes) {
    return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// 16-byte copies of an operand along MN (paths 3 and 4)
bool vec_ok(const Op& o, int elem, int batch) {
    return o.smn == 1 && aligned16(o.p) && (o.sk * elem) % 16 == 0
           && (batch == 1 || (o.sb * elem) % 16 == 0);
}

template <int BT>
int launch_simt(const Op& A, const Op& B, void* C, int M, int N, int K, long long ldc, int batch,
                long long sc, cudaStream_t s) {
    const int smem = pipe_smem<float, BT>();
    const dim3 grid((N + BT - 1) / BT, (M + BT - 1) / BT, batch);
    int rc = set_smem(simt_f32_kernel<BT>, smem);
    if (rc) return rc;
    simt_f32_kernel<BT><<<grid, PIPE_THREADS, smem, s>>>(A, B, static_cast<float*>(C), M, N, K, ldc, sc,
                                                         vec_ok(A, 4, batch), vec_ok(B, 4, batch));
    return static_cast<int>(cudaGetLastError());
}

// 16-byte copies of a K-contiguous fp64 operand (pairs of k)
bool vec_km(const Op& o, int batch) {
    return aligned16(o.p) && o.smn % 2 == 0 && (batch == 1 || o.sb % 2 == 0);
}

template <int BT, bool AKM, bool BKM>
int launch_dmma_as(const Op& A, const Op& B, void* C, int M, int N, int K, long long ldc, int batch,
                   long long sc, cudaStream_t s) {
    const int smem = dmma_smem<BT>();
    const dim3 grid((N + BT - 1) / BT, (M + BT - 1) / BT, batch);
    int rc = set_smem(dmma_f64_kernel<BT, AKM, BKM>, smem);
    if (rc) return rc;
    const int va = AKM ? vec_km(A, batch) : vec_ok(A, 8, batch);
    const int vb = BKM ? vec_km(B, batch) : vec_ok(B, 8, batch);
    dmma_f64_kernel<BT, AKM, BKM><<<grid, PIPE_THREADS, smem, s>>>(
        A, B, static_cast<double*>(C), M, N, K, ldc, sc, va, vb);
    return static_cast<int>(cudaGetLastError());
}

template <int BT>
int launch_dmma(const Op& A, const Op& B, void* C, int M, int N, int K, long long ldc, int batch,
                long long sc, cudaStream_t s) {
    if (A.sk == 1)
        return B.sk == 1 ? launch_dmma_as<BT, true, true>(A, B, C, M, N, K, ldc, batch, sc, s)
                         : launch_dmma_as<BT, true, false>(A, B, C, M, N, K, ldc, batch, sc, s);
    return B.sk == 1 ? launch_dmma_as<BT, false, true>(A, B, C, M, N, K, ldc, batch, sc, s)
                     : launch_dmma_as<BT, false, false>(A, B, C, M, N, K, ldc, batch, sc, s);
}

// A as [M, K] and B as [N, K] for TMA: K-major operands are described
// (K, MN) with 64 x rows boxes, MN-major ones (MN, K) with 64 x 64 boxes
template <typename T, int BN>
int launch_tc(int code, int out_code, const Op& A, const Op& B, void* C, int M, int N, int K,
              long long ldc, int batch, long long sc, cudaStream_t s) {
    const bool ak = A.sk == 1, bk = B.sk == 1;
    const long long lda = ak ? A.smn : A.sk, ldb = bk ? B.smn : B.sk;
    const long long sa = batch > 1 ? A.sb : lda * (ak ? M : K);
    const long long sb = batch > 1 ? B.sb : ldb * (bk ? N : K);
    if (!aligned16(A.p) || !aligned16(B.p) || lda % 8 || ldb % 8 || sa % 8 || sb % 8) return -2;
    CUtensorMap ma, mb;
    const bool ok_a = ak ? make_map(&ma, code, A.p, K, M, batch, lda, sa, TC_BK, TC_BM)
                         : make_map(&ma, code, A.p, M, K, batch, lda, sa, 64, TC_BK);
    const bool ok_b = bk ? make_map(&mb, code, B.p, K, N, batch, ldb, sb, TC_BK, BN)
                         : make_map(&mb, code, B.p, N, K, batch, ldb, sb, 64, TC_BK);
    if (!ok_a || !ok_b) return -3;
    // at least 120 KB, so that one block holds an SM: the consumers'
    // setmaxnreg.inc takes the registers the producer gives back, which a
    // second resident block could hold
    const int smem = tc_smem<BN>() > 120 * 1024 ? tc_smem<BN>() : 120 * 1024;
    int rc = set_smem(tc_kernel<T, BN>, smem);
    if (rc) return rc;
    const long long tiles = static_cast<long long>((M + TC_BM - 1) / TC_BM) * ((N + BN - 1) / BN);
    if (tiles > 0x7fffffffLL) return -2;
    const dim3 grid(static_cast<unsigned>(tiles), batch);
    tc_kernel<T, BN><<<grid, TC_THREADS, smem, s>>>(ma, mb, C, out_code, M, N, K, ldc, sc, ak, bk);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc_tile(int tile, int code, int out_code, const Op& A, const Op& B, void* C, int M,
                   int N, int K, long long ldc, int batch, long long sc, cudaStream_t s) {
    if (tile == 256) return launch_tc<T, 256>(code, out_code, A, B, C, M, N, K, ldc, batch, sc, s);
    if (tile == 128) return launch_tc<T, 128>(code, out_code, A, B, C, M, N, K, ldc, batch, sc, s);
    if (tile == 64) return launch_tc<T, 64>(code, out_code, A, B, C, M, N, K, ldc, batch, sc, s);
    return -2;
}

template <typename T, int MR>
int launch_skinny_mr(int out_code, const Op& A, const Op& B, void* C, float* W, int M, int N,
                     int K, long long ldc, int batch, long long sc, int splits, cudaStream_t s) {
    // groups of MR rows run side by side (each reads B again, from L2),
    // as many as the grid's y extent takes beside the K split
    const int groups = min((M + MR - 1) / MR, 65535 / splits);
    if (B.smn == 1) {   // row-major B: strips along N
        const int vec = aligned16(B.p) && B.sk % 8 == 0 && (batch == 1 || B.sb % 8 == 0);
        const dim3 grid((N + 127) / 128, splits * groups, batch);
        skinny_strip_kernel<T, MR><<<grid, SK_THREADS, 0, s>>>(A, B, C, W, out_code, M, N, K, ldc, sc, splits, vec);
    } else {            // K-contiguous B: dot products along K
        const int vec = aligned16(B.p) && B.smn % 8 == 0 && (batch == 1 || B.sb % 8 == 0);
        const dim3 grid((N + 31) / 32, splits * groups, batch);
        skinny_dot_kernel<T, MR><<<grid, SK_THREADS, 0, s>>>(A, B, C, W, out_code, M, N, K, ldc, sc, splits, vec);
    }
    int rc = static_cast<int>(cudaGetLastError());
    if (rc || splits == 1) return rc;
    const long long total = static_cast<long long>(M) * N * batch;
    splitk_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        W, C, out_code, M, N, batch, splits, ldc, sc);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_skinny(int out_code, const Op& A, const Op& B, void* C, float* W, int M, int N, int K,
                  long long ldc, int batch, long long sc, int splits, cudaStream_t s) {
    if (M == 1) return launch_skinny_mr<T, 1>(out_code, A, B, C, W, M, N, K, ldc, batch, sc, splits, s);
    if (M == 2) return launch_skinny_mr<T, 2>(out_code, A, B, C, W, M, N, K, ldc, batch, sc, splits, s);
    if (M <= 4) return launch_skinny_mr<T, 4>(out_code, A, B, C, W, M, N, K, ldc, batch, sc, splits, s);
    return launch_skinny_mr<T, 8>(out_code, A, B, C, W, M, N, K, ldc, batch, sc, splits, s);
}

}  // namespace

// C[z] = op(A)[z] @ op(B)[z] for z < batch, on the path kernels/gemm.py:plan
// chose.  op(A) is M x K, op(B) is K x N, C is M x N row-major with row
// stride ldc.  trans_a = 0: A is stored row-major (element (m, k) at
// m * lda + k); 1: A is a transposed view (at k * lda + m).  trans_b = 0:
// B row-major ((k, n) at k * ldb + n); 1: transposed ((k, n) at n * ldb +
// k).  sa/sb/sc are batch strides, all in elements.  `tile` is the tile
// edge of paths 1, 3 and 4 (path 1: the N edge), `splits` path 2's K
// split, with W fp32 scratch of splits * batch * M * N when splits > 1.
// Returns cudaGetLastError() after the launches, -1 for a type pair the
// kernel does not take, -2 for a shape, layout or path it cannot launch,
// -3 when TMA descriptors cannot be made.
extern "C" int repro_gemm(int in_code, int out_code, int path, int tile, int splits,
                          const void* A, const void* B, void* C, void* W, int M, int N, int K,
                          long long lda, long long ldb, long long ldc, int batch, long long sa,
                          long long sb, long long sc, int trans_a, int trans_b, void* stream) {
    if (M <= 0 || N <= 0 || K < 0 || batch <= 0 || batch > 65535) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Op a{A, trans_a ? 1 : lda, trans_a ? lda : 1, sa};
    const Op b{B, trans_b ? ldb : 1, trans_b ? 1 : ldb, sb};
    const bool half = in_code == BF16 || in_code == F16;
    if (half ? (out_code != in_code && out_code != F32) : out_code != in_code) return -1;
    switch (path) {
    case SIMT:
        if (in_code != F32) return -1;
        if ((M + tile - 1) / tile > 65535) return -2;
        if (tile == 128) return launch_simt<128>(a, b, C, M, N, K, ldc, batch, sc, s);
        if (tile == 64) return launch_simt<64>(a, b, C, M, N, K, ldc, batch, sc, s);
        return -2;
    case DMMA:
        if (in_code != F64) return -1;
        if ((M + tile - 1) / tile > 65535) return -2;
        if (tile == 128) return launch_dmma<128>(a, b, C, M, N, K, ldc, batch, sc, s);
        if (tile == 64) return launch_dmma<64>(a, b, C, M, N, K, ldc, batch, sc, s);
        return -2;
    case TC:
        if (!half) return -1;
        if (M < 64 || K < 1) return -2;
        if (in_code == BF16)
            return launch_tc_tile<__nv_bfloat16>(tile, in_code, out_code, a, b, C, M, N, K, ldc, batch, sc, s);
        return launch_tc_tile<__half>(tile, in_code, out_code, a, b, C, M, N, K, ldc, batch, sc, s);
    case SKINNY:
        if (!half) return -1;
        if (splits < 1 || splits > 65535 || (splits > 1 && W == nullptr)) return -2;
        if (in_code == BF16)
            return launch_skinny<__nv_bfloat16>(out_code, a, b, C, static_cast<float*>(W), M, N, K, ldc, batch, sc, splits, s);
        return launch_skinny<__half>(out_code, a, b, C, static_cast<float*>(W), M, N, K, ldc, batch, sc, splits, s);
    default:
        return -2;
    }
}
