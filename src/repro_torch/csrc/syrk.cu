// Rank-k update C = op(A) op(A)^T, one triangle, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/syrk.py:_syrk_kernel
// (called by `syrk`, pallas_call at syrk.py:56).  The port's `pallas`
// venue reaches it through kernels/ops.py:kernel_syrk for every real
// syrk (blas.py:_syrk_klean); the PARSEC Gram matrix Psi^T Psi (n = 2400,
// k = 93536, float64, trans T) is its main-path shape.
//
// What bounds it on an H100: the triangle needs n(n+1)k operations
// against 8(nk + n^2) bytes; at the PARSEC shape that is 5.4e11
// operations over 1.8 GB, about 290 operations per byte, far above the
// card's 67e12 / 3.35e12 = 20: the float64 tensor cores bound it, not
// device memory.
//
// Design.  The TPU kernel launched every (i, j) block of a 2-D grid and
// skipped the off-triangle ones with pl.when, carrying a VMEM accumulator
// along a sequential K grid axis.  Here only the nt(nt+1)/2 on-triangle
// tiles are launched (block index -> (i, j) by the triangular-number inverse; the
// upper triangle takes the mirrored tile), so no block is spent on the
// other half.  Tiles on the diagonal are masked at the store; the wrapper
// zero-fills the other triangle.  Ragged N and K edges are masked in the
// loads (zero fill).
//
// float64 (the main path): 128 x 128 tiles on DMMA (mma.sync m16n8k4 f64),
// 8 warps of 64 x 32 with fp64 accumulators, fed by a 3-stage cp.async ring
// of 32-deep K tiles (216 KB, one block per SM), the building blocks of
// csrc/gemm.cu's path 3 (csrc/dmma.cuh).  Both panels of a tile are rows of
// the same op(A), each staged in the layout it has in device memory: with
// trans T (A is K x N, Psi itself) op(A)'s rows are MN-contiguous and are
// staged k-major; with trans N they are K-contiguous and staged as they
// lie.  A tile on the diagonal stages one panel and reads it as both
// operands.  At n 2400 there are only 190 such tiles, 1.44 waves of
// 93536-deep blocks on 132 SMs, so K is split across blocks as
// kernels/syrk.py:plan says (9 ranges there: 1710 blocks, 12.95 waves, the
// last one 95% full).  Each block writes its tile's partial sum to fp64
// scratch that the wrapper allocates, and a second, small launch sums a
// tile's partials in split order (no atomics: the same inputs give the
// same bits on every call), masks the diagonal tiles and writes C.  With
// one range the first launch writes C itself.
//
// float32, bfloat16, float16 (float32 accumulators, output in the input
// type, as syrk.py:54): 64 x 64 tiles on the FMA units, each block walking
// all of K with a 4x4 register tile per thread; no main path runs them.
#include "dmma.cuh"

namespace {

constexpr int BT = 64;        // tile edge of C, FMA kernel
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TT = BT / 16;   // rows (and columns) per thread, stride 16
constexpr int DT = 128;       // tile edge of C, DMMA kernel
constexpr int RED_THREADS = 256;

// dtype codes shared with kernels/gemm.py
enum Code { F32 = 0, F64 = 1, BF16 = 2, F16 = 3 };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

// Tile t of the lower triangle, numbered row by row: (ti, tj), tj <= ti.
__device__ __forceinline__ void tile_of(long long t, int& ti, int& tj) {
    int i = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
    while (static_cast<long long>(i + 1) * (i + 2) / 2 <= t) ++i;
    while (static_cast<long long>(i) * (i + 1) / 2 > t) --i;
    ti = i;
    tj = static_cast<int>(t - static_cast<long long>(i) * (i + 1) / 2);
}

// (row0, col0) of on-triangle tile t of edge `edge`
__device__ __forceinline__ void tile_origin(long long t, int edge, int lower, int& row0, int& col0) {
    int ti, tj;
    tile_of(t, ti, tj);
    if (!lower) { const int x = ti; ti = tj; tj = x; }
    row0 = ti * edge;
    col0 = tj * edge;
}

// ---------------------------------------------------------------------------
// float32 / bfloat16 / float16 on the FMA units
// ---------------------------------------------------------------------------
template <typename In, bool TRANS>
__global__ void __launch_bounds__(THREADS)
syrk_kernel(const In* __restrict__ A, In* __restrict__ C, int N, int K,
            long long lda, long long ldc, long long sa, long long sc,
            int lower) {
    // Ps[kk][r] = op(A)[row0 + r][k0 + kk], Qs the same for col0; the +1
    // keeps the transposing store of trans = N off one bank
    __shared__ float Ps[BK][BT + 1];
    __shared__ float Qs[BK][BT + 1];

    int row0, col0;
    tile_origin(blockIdx.x, BT, lower, row0, col0);
    A += blockIdx.y * sa;
    C += blockIdx.y * sc;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float acc[TT][TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        if (TRANS) {
            // A is K x N: op(A)[r][k] = A[k][r]; neighbouring threads read
            // neighbouring columns of one row of A
            for (int e = tid; e < BK * BT; e += THREADS) {
                const int kk = e / BT, r = e % BT;
                const long long gk = k0 + kk;
                const int gr = row0 + r, gc = col0 + r;
                const bool kin = gk < K;
                Ps[kk][r] = (kin && gr < N) ? to_acc(A[gk * lda + gr]) : 0.f;
                Qs[kk][r] = (kin && gc < N) ? to_acc(A[gk * lda + gc]) : 0.f;
            }
        } else {
            // A is N x K: neighbouring threads read neighbouring k
            for (int e = tid; e < BT * BK; e += THREADS) {
                const int r = e / BK, kk = e % BK;
                const int gk = k0 + kk;
                const long long gr = row0 + r, gc = col0 + r;
                const bool kin = gk < K;
                Ps[kk][r] = (kin && gr < N) ? to_acc(A[gr * lda + gk]) : 0.f;
                Qs[kk][r] = (kin && gc < N) ? to_acc(A[gc * lda + gk]) : 0.f;
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TT], b[TT];
#pragma unroll
            for (int i = 0; i < TT; ++i) a[i] = Ps[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TT; ++j) b[j] = Qs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TT; ++i)
#pragma unroll
                for (int j = 0; j < TT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    // only the uplo triangle is written; a tile on the diagonal is masked
#pragma unroll
    for (int i = 0; i < TT; ++i) {
        const int gr = row0 + ty + 16 * i;
        if (gr >= N) continue;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const int gc = col0 + tx + 16 * j;
            const bool on_tri = lower ? (gc <= gr) : (gc >= gr);
            if (gc < N && on_tri)
                store(&C[static_cast<long long>(gr) * ldc + gc], acc[i][j]);
        }
    }
}

// ---------------------------------------------------------------------------
// float64 on the DMMA tensor cores, K split across blocks
// ---------------------------------------------------------------------------
// Block x = split * tiles + tile of batch y computes op(A)[rows i] .
// op(A)[rows j]^T over K range [split * chunk, min(K, (split + 1) * chunk)),
// so the blocks of one wave share a K range and its rows of A in L2.  8 warps
// as 2 x 4, each 64 x 32 of 16 x 8 mma tiles; the fragments of m16n8k4 (g =
// l/4, t = l%4 for lane l): A[g][t] and A[g+8][t], B[t][g], and C[g][2t],
// C[g][2t+1], C[g+8][2t], C[g+8][2t+1].  KM: op(A) is K-contiguous (trans
// N), staged [mn][k]; else MN-contiguous (trans T), staged [k][mn].  With
// `direct` the tile is masked and written into C; otherwise the whole tile
// goes to W[(y * splits + split) * tiles + tile] for syrk_reduce_kernel.
template <bool KM>
__global__ void __launch_bounds__(THREADS)
syrk_dmma_kernel(Op A, double* __restrict__ C, double* __restrict__ W, int N, int K,
                 long long ldc, long long sc, int lower, int tiles, int splits,
                 int chunk, int vec, int direct) {
    constexpr int BKD = DMMA_BK, S = DMMA_STAGES, LDS = pipe_lds<double, DT>();
    constexpr int LDK = DMMA_LDK, TILE = dmma_tile<DT>();
    constexpr int WM = DT / 2, WN = DT / 4, MT = WM / 16, NT = WN / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* As = reinterpret_cast<double*>(smem_raw);
    double* Bs = As + S * TILE;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm0 = (warp / 4) * WM, wn0 = (warp % 4) * WN;
    const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles, z = blockIdx.y;
    int m0, n0;
    tile_origin(tile, DT, lower, m0, n0);
    const bool diag = m0 == n0;
    const double* ga = static_cast<const double*>(A.p) + z * A.sb;
    const int kb = split * chunk;
    const int ke = min(K, kb + chunk);         // the loaders zero-fill from ke on
    const int KT = ke > kb ? (ke - kb + BKD - 1) / BKD : 0;

    double acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;

    auto load_panel = [&](double* s, int mn0, int k0) {
        if constexpr (KM)
            load_tile_km<DT, BKD, LDK, THREADS>(s, ga, A.smn, A.sk, N, ke, mn0, k0, tid, vec);
        else
            load_tile<double, DT, BKD, LDS, THREADS>(s, ga, A.smn, A.sk, N, ke, mn0, k0, tid, vec);
    };
    auto load = [&](int t) {
        load_panel(As + (t % S) * TILE, m0, kb + t * BKD);
        if (!diag) load_panel(Bs + (t % S) * TILE, n0, kb + t * BKD);
    };
    // element (mn, k) of a staged tile
    auto at = [&](const double* s, int mn, int k) { return KM ? s[mn * LDK + k] : s[k * LDS + mn]; };
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
        const double* bs = diag ? as : Bs + (t % S) * TILE;
#pragma unroll
        for (int kq = 0; kq < BKD / 4; ++kq) {
            const int k = kq * 4 + t4;
            double a[MT][2], b[NT];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                a[i][0] = at(as, wm0 + i * 16 + g, k);
                a[i][1] = at(as, wm0 + i * 16 + 8 + g, k);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) b[j] = at(bs, wn0 + j * 8 + g, k);
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j) dmma(acc[i][j], a[i][0], a[i][1], b[j]);
        }
    }
    cp_wait<0>();

    if (direct) {
        C += z * sc;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + wm0 + i * 16 + h * 8 + g;
                if (r >= N) continue;
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int c = n0 + wn0 + j * 8 + 2 * t4 + e;
                        const bool on_tri = lower ? (c <= r) : (c >= r);
                        if (c < N && on_tri) C[static_cast<long long>(r) * ldc + c] = acc[i][j][2 * h + e];
                    }
            }
        return;
    }
    double* w = W + ((static_cast<long long>(z) * splits + split) * tiles + tile) * (DT * DT);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = wm0 + i * 16 + h * 8 + g;
#pragma unroll
            for (int j = 0; j < NT; ++j)
                *reinterpret_cast<double2*>(w + r * DT + wn0 + j * 8 + 2 * t4) =
                    make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
}

// One block per (tile, batch): C's tile = the sum of its `splits` partials
// in split order, masked to the triangle.  Each thread takes pairs of
// neighbouring columns, so reads and writes are 16-byte and coalesced.
__global__ void __launch_bounds__(RED_THREADS)
syrk_reduce_kernel(const double* __restrict__ W, double* __restrict__ C, int N,
                   long long ldc, long long sc, int lower, int tiles, int splits) {
    const int tile = blockIdx.x, z = blockIdx.y;
    int m0, n0;
    tile_origin(tile, DT, lower, m0, n0);
    const long long stride = static_cast<long long>(tiles) * DT * DT;
    const double* w = W + (static_cast<long long>(z) * splits * tiles + tile) * (DT * DT);
    C += z * sc;
    for (int e = threadIdx.x * 2; e < DT * DT; e += RED_THREADS * 2) {
        const int r = m0 + e / DT, c = n0 + e % DT;
        if (r >= N) break;                       // rows only grow with e
        double2 s = *reinterpret_cast<const double2*>(w + e);
        for (int p = 1; p < splits; ++p) {
            const double2 x = *reinterpret_cast<const double2*>(w + p * stride + e);
            s.x += x.x;
            s.y += x.y;
        }
        double* out = C + static_cast<long long>(r) * ldc + c;
        if (c < N && (lower ? c <= r : c >= r)) out[0] = s.x;
        if (c + 1 < N && (lower ? c + 1 <= r : c + 1 >= r)) out[1] = s.y;
    }
}

template <typename In>
int launch_fma(const void* A, void* C, int N, int K, long long lda,
               long long ldc, int batch, long long sa, long long sc, int trans,
               int lower, cudaStream_t stream) {
    const long long nt = (N + BT - 1) / BT;
    dim3 grid(static_cast<unsigned>(nt * (nt + 1) / 2), batch);
    const In* a = static_cast<const In*>(A);
    In* c = static_cast<In*>(C);
    if (trans)
        syrk_kernel<In, true><<<grid, THREADS, 0, stream>>>(
            a, c, N, K, lda, ldc, sa, sc, lower);
    else
        syrk_kernel<In, false><<<grid, THREADS, 0, stream>>>(
            a, c, N, K, lda, ldc, sa, sc, lower);
    return static_cast<int>(cudaGetLastError());
}

template <bool KM>
int launch_dmma_km(const Op& a, double* C, double* W, int N, int K, long long ldc, int batch,
                   long long sc, int lower, int tiles, int splits, int chunk, int vec,
                   cudaStream_t s) {
    const int smem = dmma_smem<DT>();
    int rc = set_smem(syrk_dmma_kernel<KM>, smem);
    if (rc) return rc;
    const dim3 grid(static_cast<unsigned>(tiles) * splits, batch);
    syrk_dmma_kernel<KM><<<grid, THREADS, smem, s>>>(a, C, W, N, K, ldc, sc, lower, tiles,
                                                      splits, chunk, vec, splits == 1);
    rc = static_cast<int>(cudaGetLastError());
    if (rc || splits == 1) return rc;
    syrk_reduce_kernel<<<dim3(tiles, batch), RED_THREADS, 0, s>>>(W, C, N, ldc, sc, lower,
                                                                  tiles, splits);
    return static_cast<int>(cudaGetLastError());
}

int launch_dmma(const void* A, void* C, void* W, int N, int K, long long lda, long long ldc,
                int batch, long long sa, long long sc, int trans, int lower, int splits,
                int chunk, cudaStream_t s) {
    const long long nt = (N + DT - 1) / DT;
    const long long tiles = nt * (nt + 1) / 2;
    if (splits < 1 || tiles * splits > 2147483647LL) return -2;
    // every split starts on a K tile (16-byte copies stay aligned), holds
    // some of K, and together they cover it
    if (splits > 1 && (W == nullptr || chunk <= 0 || chunk % DMMA_BK != 0
                       || static_cast<long long>(chunk) * (splits - 1) >= K
                       || static_cast<long long>(chunk) * splits < K))
        return -2;
    if (splits == 1) chunk = K;
    double* c = static_cast<double*>(C);
    double* w = static_cast<double*>(W);
    const Op a{A, trans ? 1 : lda, trans ? lda : 1, sa};
    if (trans)
        return launch_dmma_km<false>(a, c, w, N, K, ldc, batch, sc, lower, static_cast<int>(tiles),
                                     splits, chunk, vec_ok(a, 8, batch), s);
    return launch_dmma_km<true>(a, c, w, N, K, ldc, batch, sc, lower, static_cast<int>(tiles),
                                splits, chunk, vec_km(a, batch), s);
}

}  // namespace

// C[z] = op(A[z]) op(A[z])^T on the `lower` (1) or upper (0) triangle for
// z < batch.  op(A) is N x K: A itself (trans = 0, A is N x K) or A^T
// (trans = 1, A is K x N).  A and C have unit column strides; lda/ldc are
// row strides and sa/sc batch strides, in elements.  C's other triangle
// is not written.  float64 splits K into `splits` ranges of `chunk`
// (kernels/syrk.py:plan) and, with splits > 1, needs W: float64 scratch of
// batch * splits * tiles * 128 * 128 values, tiles = nt(nt+1)/2 for
// nt = ceil(N / 128); the other types take neither.  Returns
// cudaGetLastError() after the launches (two with splits > 1: the tiles,
// then the sum of their partials), -1 for a dtype the kernel does not take
// and -2 for a grid or split the card cannot launch.
extern "C" int repro_syrk(int code, const void* A, void* C, int N, int K,
                          long long lda, long long ldc, int batch,
                          long long sa, long long sc, int trans, int lower,
                          int splits, int chunk, void* W, void* stream) {
    if (N <= 0 || K < 0 || batch <= 0 || batch > 65535) return -2;
    const long long nt = (N + BT - 1) / BT;
    if (nt * (nt + 1) / 2 > 2147483647LL) return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (code == F64)
        return launch_dmma(A, C, W, N, K, lda, ldc, batch, sa, sc, trans, lower, splits, chunk, s);
    if (code == F32)
        return launch_fma<float>(A, C, N, K, lda, ldc, batch, sa, sc, trans, lower, s);
    if (code == BF16)
        return launch_fma<__nv_bfloat16>(A, C, N, K, lda, ldc, batch, sa, sc, trans, lower, s);
    if (code == F16)
        return launch_fma<__half>(A, C, N, K, lda, ldc, batch, sa, sc, trans, lower, s);
    return -1;
}
