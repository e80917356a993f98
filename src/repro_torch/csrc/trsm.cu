// Triangular solve L X = B for Hopper (sm_90a), plain C interface: one
// launch for narrow right-hand sides (the dataflow path), two for wide ones
// (the wide path, at the end of this note).
//
// Replaces the Pallas TPU kernel src/repro/kernels/trsm.py:_trsm_base_kernel
// (called by `_trsm_base`, pallas_call at trsm.py:66) together with the
// recursion around it (`_solve_lower`, trsm.py:80): the TPU solves 128-row
// diagonal blocks by row substitution and leaves the updates between them
// to gemm calls.  Here one launch solves the whole lower-left problem; the
// reduction of the other side/uplo/trans variants to it stays in Python
// (kernels/trsm.py:_canonical).
//
// What bounds it on an H100: the main path's solve (float64, m = 6912 rows,
// 32 right-hand sides) reads the m*m/2 triangle once (191 MB, 0.058 ms at
// 3.35 TB/s) and does m*m*n operations (1.5 GFLOP, 0.023 ms at 67 TFLOP/s),
// so the card's bound is its memory.  But the solve is a chain: block row i
// needs every X_j above it.  The earlier design issued that chain from
// Python as ~300 launches (54 one-block substitution kernels of 128
// dependent steps each, 53 gemm updates, subtractions and concatenations),
// and latency bounded it at ~8 ms.
//
// Design: one block of 256 threads per (batch, 32-column panel of B,
// 64-row block row i).  Each block takes a ticket from a global counter
// (atomicAdd) and works on the unit that the ticket names, in row-major
// order (batch, panel, row).  A block only ever waits on blocks of smaller
// tickets, which are already running, so the kernel cannot deadlock however
// many blocks fit on the card.  Block i accumulates
//     R'_i = B_i - sum_{j < i-1} L_ij X_j
// taking each X_j as soon as it is published, and reads each L_ij tile
// once (cp.async, 16-byte copies where the rows allow, three tiles in
// flight), so the whole triangle is read once.  When it runs behind the
// chain, X_{j+1} is already published and is fetched into registers while
// X_j's product runs.
//
// The diagonal step: block i inverts its 64 x 64 diagonal block L_ii at its
// start, by the column-oriented substitution of the earlier base kernel
// applied to the identity, and forms M_i = L_ii^-1 L_i,i-1, while the
// blocks above it are still solving.  Then
//     X_i = L_ii^-1 R'_i - M_i X_{i-1},
// and only the second product waits on the block row above: the step on
// the chain is one 64 x 64 by 64 x 32 product, not 64 dependent
// substitution steps (the inverse is the choice of MAGMA's and cuBLAS's
// trsm).  Its numerics differ from substitution's: the error of X_i grows
// with the condition of L_ii, not only with that of the solve.  The CPU
// tests pin it on the unit-lower triangles of LU factors as well as on
// diagonally dominant ones (tests/test_torch_trsm_dataflow.py), and
// kernels/trsm.py:trsm_dataflow_plain is this order in plain PyTorch.
//
// Publishing: block i stores X_i, then __syncthreads(), then one thread
// runs __threadfence() and a release store of i + 1 into its chain's
// count of published block rows (a chain is one (batch, panel); block i
// publishes only after block i - 1, so the count only grows).  A
// consumer's thread 0 spins on an acquire load of the count, then a
// barrier, and the block reads X through L2 (ld.global.cg): X is written
// during the launch, so it must never be read through L1 or the
// non-coherent path (no const __restrict__ on it).  A spin that outlasts
// 4 s traps, so a fault fails the launch instead of holding the card.  The
// wrapper allocates the counts and the ticket counter zeroed (one memset);
// the kernel allocates nothing.  Types: float32 and float64; unit or
// non-unit diagonal; any m, n >= 1 (a ragged last block row or panel is
// padded with the identity and zeros, never stored).  The float64 products
// run on the tensor cores (mma.sync m16n8k4, as csrc/gemm.cu's DMMA path:
// 16 mma per warp for a 64 x 64 by 64 x 32 product), the float32 ones on
// the FMA units (TF32 would miss float32's tolerance).
//
// The wide path (repro_trsm_wide): taken when the 128-column panels of B
// alone give every SM a block, ceil(n / 128) * batch >= 132
// (kernels/trsm.py:plan); CheFSI's Psi R^-1 at m 2400, n 93536 has 731.
// There the dataflow path's parallelism is wasted: 111,074 units of one
// block per SM (210 KB of shared memory each), each inverting its L_ii
// again, and the ~132 resident ones the rows of three or four chains that
// spin on one another.  What bounds the wide solve: m*m*n operations, 8.04
// ms at 67 TFLOP/s for CheFSI's, against the bytes of B and X once (3.6
// GB, 1.07 ms) and each block's re-reads of its own X, n * 8 * m^2 / (2 *
// 128) B in all (16.8 GB, ~5 ms, from device memory: 132 panels of up to
// 2.4 MB outgrow L2), which overlap the products.  Design:
// - A prologue of ceil(m / 64) * batch blocks writes each 64-row diagonal
//   block's inverse W_i once, by the dataflow path's substitution, and for
//   the second 64 rows of each 128-row block row M_i = W_i L_i,i-1, into a
//   scratch that the wrapper allocates: the numerics of the dataflow path's
//   64-row steps, computed 38 times for CheFSI instead of 111,074.
// - The main launch gives one block of 256 threads to each (batch, 128-
//   column panel) and walks the 128-row block rows in order: acc = B_I -
//   L_I,<I X_<I on csrc/gemm.cu's DMMA tile (8 warps of 64 x 32, a 3-stage
//   cp.async ring of 128 x 32 L and 32 x 128 X tiles, each A fragment
//   feeding 4 mma; float32 on the FMA units, 8 x 8 a thread), then the
//   block row staged in shared memory and X_a = W_a R_a, X_b = W_b R_b -
//   M_b X_a with W and M read from the scratch.  A block reads only the X it
//   stored itself, after a barrier: no tickets, flags, spins or memset.
//   128-row block rows halve the X re-reads of 64-row ones and keep a
//   thread's accumulators at 64 (128 registers in float64); 128 columns
//   make 731 blocks, 5.5 waves of one block an SM (the ring takes 210 KB).
#include "dmma.cuh"

namespace {

constexpr int NB = 64;        // rows of a block row
constexpr int PANEL = 32;     // columns of a panel
constexpr int THREADS = 256;
constexpr int NBUF = 3;       // L_ij tiles in flight
constexpr int PS = 36;        // padded row stride of the 64 x 32 panels

// dtype codes shared with kernels/gemm.py and kernels/trsm.py
enum Code { F32 = 0, F64 = 1 };

// padded row stride of the 64 x 64 tiles: rows 16-byte aligned for the
// 16-byte copies, and 68 = 4 mod 16, so that an mma fragment's 32 reads
// (and the FMA path's two rows) fall on distinct banks; PS likewise
constexpr int LDS = 68;

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
    // L_ii then M_i, L_ii^-1, NBUF L_ij tiles, two X_j / R_i panels
    return sizeof(T) * ((2 + NBUF) * NB * LDS + 2 * NB * PS);
}

// the R x C tile of L at rows r0.., columns c0.. into s (row stride LD),
// zero outside m x m; whole rows in 16-byte copies where `vec` allows
template <typename T, int R = NB, int C = NB, int LD = LDS>
__device__ __forceinline__ void load_block(T* s, const T* L, long long ldl, int m, int r0, int c0,
                                           bool vec, int tid) {
    if (vec && c0 + C <= m) {
        constexpr int PER = 16 / sizeof(T);
        for (int e = tid; e < R * C / PER; e += THREADS) {
            const int r = e / (C / PER), c = (e % (C / PER)) * PER;
            const bool ok = r0 + r < m;
            cp_async<16>(&s[r * LD + c], ok ? &L[(r0 + r) * ldl + c0 + c] : L, ok);
        }
    } else {
        for (int e = tid; e < R * C; e += THREADS) {
            const int r = e / C, c = e % C;
            const bool ok = r0 + r < m && c0 + c < m;
            cp_async<sizeof(T)>(&s[r * LD + c], ok ? &L[(r0 + r) * ldl + c0 + c] : L, ok);
        }
    }
}

// W = L_ii^-1 for the diagonal block Ld of nb rows, W the identity on
// entry: row i is finished, then leaves every row below; rows past nb stay
// the identity
template <typename T>
__device__ __forceinline__ void invert_block(T* W, const T* Ld, int nb, int unit, int tid) {
    for (int i = 0; i < nb; ++i) {
        if (!unit) {
            if (tid <= i) W[i * LDS + tid] = W[i * LDS + tid] / Ld[i * LDS + i];
            __syncthreads();
        }
        const int below = nb - 1 - i, cols = i + 1;
        for (int e = tid; e < below * cols; e += THREADS) {
            const int r = i + 1 + e / cols, c = e % cols;
            W[r * LDS + c] -= Ld[r * LDS + i] * W[i * LDS + c];
        }
        __syncthreads();
    }
}

__device__ __forceinline__ uint64_t now_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// spin until the chain's count of published block rows exceeds j; returns
// the count seen (a spin that outlasts 4 s traps)
__device__ __forceinline__ unsigned wait_done(const unsigned* done, int j) {
    unsigned v;
    const uint64_t t0 = now_ns();
    for (unsigned spins = 0;; ++spins) {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(done) : "memory");
        if (v > static_cast<unsigned>(j)) return v;
        if ((spins & 1023u) == 1023u && now_ns() - t0 > 4000000000ull) __trap();
    }
}

__device__ __forceinline__ void publish(unsigned* done, unsigned count) {
    __threadfence();
    asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(done), "r"(count) : "memory");
}

// Each thread's share of a 64 x 16NC product, 4NC elements: float64 on the
// tensor cores (mma.sync m16n8k4, 8 warps as 4 x 2, each 16 rows x 8NC
// columns), float32 on the FMA units (4 rows x NC columns per thread).
// Element e of a thread sits at row r, column c:
template <typename T, int NC>
__device__ __forceinline__ void coords(int e, int tid, int& r, int& c) {
    if constexpr (sizeof(T) == 8) {
        const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
        r = 16 * (warp >> 1) + g + 8 * ((e & 3) >> 1);
        c = (warp & 1) * 8 * NC + 8 * (e >> 2) + 2 * t + (e & 1);
    } else {
        r = tid / 16 + 16 * (e / NC);
        c = tid % 16 + 16 * (e % NC);
    }
}

// acc -/+= A . P over k < 64: A a 64 x 64 tile (row stride LDS), P 64 rows
// of 16 NC columns (row stride PST)
template <typename T, bool SUB, int NC, int PST>
__device__ __forceinline__ void tile_product(T (&acc)[4 * NC], const T* A, const T* P, int tid) {
    if constexpr (sizeof(T) == 8) {
        const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
        const T* a_row = A + (16 * (warp >> 1) + g) * LDS + t;
        const T* p_col = P + t * PST + (warp & 1) * 8 * NC + g;
#pragma unroll 4
        for (int kq = 0; kq < NB / 4; ++kq) {
            const T a0 = a_row[4 * kq], a1 = a_row[8 * LDS + 4 * kq];
#pragma unroll
            for (int jn = 0; jn < NC; ++jn)
                dmma(&acc[4 * jn], SUB ? -a0 : a0, SUB ? -a1 : a1, p_col[4 * kq * PST + 8 * jn]);
        }
    } else {
        const int ty = tid / 16, tx = tid % 16;
#pragma unroll 8
        for (int k = 0; k < NB; ++k) {
            T a[4], p[NC];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * LDS + k];
#pragma unroll
            for (int c = 0; c < NC; ++c) p[c] = P[k * PST + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    if (SUB) acc[r * NC + c] -= a[r] * p[c];
                    else acc[r * NC + c] += a[r] * p[c];
                }
        }
    }
}

// rows row0.. of the output's panel into registers, read through L2: X is
// written during the launch, so never through L1 or the non-coherent path
template <typename T>
__device__ __forceinline__ void load_x(T (&xr)[8], const T* X, long long ldx, int n, int row0,
                                       int c0, int tid) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const int e = tid + q * THREADS, r = e / PANEL, gc = c0 + e % PANEL;
        xr[q] = gc < n ? __ldcg(&X[static_cast<long long>(row0 + r) * ldx + gc]) : T(0);
    }
}
template <typename T>
__device__ __forceinline__ void store_x(T* P, const T (&xr)[8], int tid) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const int e = tid + q * THREADS;
        P[(e / PANEL) * PS + e % PANEL] = xr[q];
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
trsm_dataflow_kernel(const T* __restrict__ L, const T* __restrict__ B, T* X, int m, int n,
                     long long ldl, long long ldb, long long ldx, long long sl, long long sb,
                     long long sx, int unit, int vec, int rows, int panels, unsigned* done,
                     unsigned* ticket) {
    constexpr int TILE = NB * LDS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ld = reinterpret_cast<T*>(smem_raw);   // L_ii, then M_i = L_ii^-1 L_i,i-1
    T* W = Ld + TILE;                          // L_ii^-1
    T* Lt = W + TILE;                          // NBUF L_ij tiles
    T* P = Lt + NBUF * TILE;                   // two 64 x 32 panels
    __shared__ unsigned s_unit, s_avail;

    const int tid = threadIdx.x;
    if (tid == 0) {
        s_unit = atomicAdd(ticket, 1u);
        s_avail = 0;
    }
    __syncthreads();
    const unsigned t = s_unit;
    const int row = static_cast<int>(t % rows);
    const int panel = static_cast<int>((t / rows) % panels);
    const int z = static_cast<int>(t / rows / panels);
    const int i0 = row * NB, c0 = panel * PANEL;
    const int nb = min(NB, m - i0);
    const int last = row - 1;                  // the update folded into M_i
    L += z * sl;
    B += z * sb;
    X += z * sx;
    unsigned* chain = done + static_cast<long long>(z) * panels + panel;

    // groups: {L_ii, L_i,i-1}, {L_i0}, {L_i1} (empty groups keep the count)
    load_block(Ld, L, ldl, m, i0, i0, vec, tid);
    if (last >= 0) load_block(Lt + 2 * TILE, L, ldl, m, i0, last * NB, vec, tid);
    cp_commit();
    if (last > 0) load_block(Lt, L, ldl, m, i0, 0, vec, tid);
    cp_commit();
    if (last > 1) load_block(Lt + TILE, L, ldl, m, i0, NB, vec, tid);
    cp_commit();

    T acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        int r, c;
        coords<T, 2>(e, tid, r, c);
        acc[e] = (i0 + r < m && c0 + c < n) ? B[(i0 + r) * ldb + c0 + c] : T(0);
    }
    for (int e = tid; e < NB * NB; e += THREADS) W[(e / NB) * LDS + e % NB] = T(e / NB == e % NB);
    cp_wait<2>();
    __syncthreads();

    invert_block(W, Ld, nb, unit, tid);
    // M_i = L_ii^-1 L_i,i-1 into Ld's place
    if (last >= 0) {
        T mt[16] = {};
        tile_product<T, false, 4, LDS>(mt, W, Lt + 2 * TILE, tid);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            int r, c;
            coords<T, 4>(e, tid, r, c);
            Ld[r * LDS + c] = mt[e];
        }
    }
    __syncthreads();

    // R'_i = B_i - sum_{j < i-1} L_ij X_j, each X_j once it is published;
    // X_{j+1} is fetched into registers while X_j's product runs
    T xr[8];
    bool have = false;
    for (int j = 0; j < last; ++j) {
        if (j + 2 < last) load_block(Lt + ((j + 2) % NBUF) * TILE, L, ldl, m, i0, (j + 2) * NB, vec, tid);
        cp_commit();
        T* Pj = P + (j & 1) * NB * PS;
        if (!have) {
            if (tid == 0 && s_avail <= static_cast<unsigned>(j)) s_avail = wait_done(chain, j);
            __syncthreads();
            load_x(xr, X, ldx, n, j * NB, c0, tid);
        }
        store_x(Pj, xr, tid);
        have = j + 1 < last && s_avail > static_cast<unsigned>(j + 1);
        if (have) load_x(xr, X, ldx, n, (j + 1) * NB, c0, tid);
        cp_wait<2>();
        __syncthreads();
        tile_product<T, true, 2, PS>(acc, Lt + (j % NBUF) * TILE, Pj, tid);
        __syncthreads();
    }

    // X_i = L_ii^-1 R'_i - M_i X_{i-1}: only the second product waits on
    // the block row above
    T* Pr = P;
    T* Px = P + NB * PS;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        int r, c;
        coords<T, 2>(e, tid, r, c);
        Pr[r * PS + c] = acc[e];
    }
    __syncthreads();
    T out[8] = {};
    tile_product<T, false, 2, PS>(out, W, Pr, tid);
    if (last >= 0) {
        if (tid == 0 && s_avail <= static_cast<unsigned>(last)) s_avail = wait_done(chain, last);
        __syncthreads();
        load_x(xr, X, ldx, n, last * NB, c0, tid);
        store_x(Px, xr, tid);
        __syncthreads();
        tile_product<T, true, 2, PS>(out, Ld, Px, tid);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        int r, c;
        coords<T, 2>(e, tid, r, c);
        if (i0 + r < m && c0 + c < n) X[static_cast<long long>(i0 + r) * ldx + c0 + c] = out[e];
    }
    __syncthreads();
    if (tid == 0) publish(chain, static_cast<unsigned>(row + 1));
}

template <typename T>
int launch(const void* L, const void* B, void* X, int m, int n, long long ldl, long long ldb,
           long long ldx, int batch, long long sl, long long sb, long long sx, int unit,
           unsigned* flags, cudaStream_t stream) {
    const size_t smem = smem_bytes<T>();
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&trsm_dataflow_kernel<T>),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = (m + NB - 1) / NB, panels = (n + PANEL - 1) / PANEL;
    const long long units = static_cast<long long>(rows) * panels * batch;
    const int vec = (reinterpret_cast<uintptr_t>(L) % 16 == 0) && (ldl * sizeof(T)) % 16 == 0
                    && (batch == 1 || (sl * sizeof(T)) % 16 == 0);
    trsm_dataflow_kernel<T><<<static_cast<unsigned>(units), THREADS, smem, stream>>>(
        static_cast<const T*>(L), static_cast<const T*>(B), static_cast<T*>(X), m, n, ldl, ldb,
        ldx, sl, sb, sx, unit, vec, rows, panels, flags, flags + panels * batch);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wide path
// ---------------------------------------------------------------------------
constexpr int WR = 128;       // rows of a block row: two 64-row diagonal steps
constexpr int WW = 128;       // columns of a panel
constexpr int WK = 32;        // depth of a staged L / X tile
constexpr int WS = 3;         // stages of the cp.async ring
constexpr int WLK = WK + 4;   // row stride of the staged L tiles ([row][k], as dmma.cuh's)
constexpr int DIAG = NB * NB; // one 64 x 64 matrix of the prologue's scratch

// row stride of the staged X tiles ([k][col]) and of the block row staged
// as the diagonal step's right operand
template <typename T>
__host__ __device__ constexpr int wide_ld() { return pipe_lds<T, WW>(); }
template <typename T>
__host__ __device__ constexpr int wide_stage() { return WR * WLK + WK * wide_ld<T>(); }
template <typename T>
__host__ __device__ constexpr size_t wide_smem() { return sizeof(T) * WS * wide_stage<T>(); }
static_assert(WR * wide_ld<double>() <= WS * wide_stage<double>(), "a block row fits the ring");
static_assert(WR * wide_ld<float>() <= WS * wide_stage<float>(), "a block row fits the ring");

// Element e of a thread's 64 of a 128 x 128 block row sits at row r, column
// c: float64 as csrc/gemm.cu's DMMA path (8 warps as 2 x 4 of 64 x 32, 4 x 4
// mma tiles each), float32 as its FMA path (16 x 16 threads, rows
// 64 h + 4 ty + i, columns 64 g + 4 tx + j).  Either way rows [64 h, 64 h +
// 64) are elements [32 h, 32 h + 32) in float32, and warps 4 h.. in float64.
template <typename T>
__device__ __forceinline__ void wide_coords(int e, int tid, int& r, int& c) {
    if constexpr (sizeof(T) == 8) {
        const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
        r = (warp / 4) * 64 + (e / 16) * 16 + g + 8 * ((e & 3) >> 1);
        c = (warp % 4) * 32 + ((e / 4) % 4) * 8 + 2 * t + (e & 1);
    } else {
        const int ty = tid / 16, tx = tid % 16;
        r = (e / 32) * 64 + ty * 4 + (e / 8) % 4;
        c = ((e / 4) % 2) * 64 + tx * 4 + e % 4;
    }
}

// acc += A . P over one staged depth: A the block row's WR x WK tile of L
// ([row][k], stride WLK), P the WK x WW tile of X ([k][col])
template <typename T>
__device__ __forceinline__ void wide_update(T (&acc)[64], const T* A, const T* P, int tid) {
    constexpr int LD = wide_ld<T>();
    if constexpr (sizeof(T) == 8) {
        const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
        const T* a_row = A + ((warp / 4) * 64 + g) * WLK + t;
        const T* p_col = P + t * LD + (warp % 4) * 32 + g;
#pragma unroll
        for (int kq = 0; kq < WK / 4; ++kq) {
            T a[4][2], p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                a[i][0] = a_row[i * 16 * WLK + 4 * kq];
                a[i][1] = a_row[(i * 16 + 8) * WLK + 4 * kq];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) p[j] = p_col[4 * kq * LD + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) dmma(&acc[(i * 4 + j) * 4], a[i][0], a[i][1], p[j]);
        }
    } else {
        const int ty = tid / 16, tx = tid % 16;
#pragma unroll 4
        for (int k = 0; k < WK; ++k) {
            T a[8], p[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) a[q] = A[((q / 4) * 64 + ty * 4 + q % 4) * WLK + k];
#pragma unroll
            for (int q = 0; q < 8; ++q) p[q] = P[k * LD + (q / 4) * 64 + tx * 4 + q % 4];
#pragma unroll
            for (int q = 0; q < 8; ++q)
#pragma unroll
                for (int s = 0; s < 8; ++s) acc[(q / 4) * 32 + (q % 4) * 8 + s] += a[q] * p[s];
        }
    }
}

// out +/-= A . S over k < 64 for the thread's elements in rows [64 h, 64 h +
// 64): A one of the prologue's 64 x 64 matrices (row-major, in device
// memory, read through L1), S the 64 staged rows it multiplies ([k][col])
template <typename T, bool SUB>
__device__ __forceinline__ void wide_diag(T (&out)[64], const T* __restrict__ A, const T* S, int h,
                                          int tid) {
    constexpr int LD = wide_ld<T>();
    if constexpr (sizeof(T) == 8) {
        const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
        if (warp / 4 != h) return;
        const T* a_row = A + g * NB + t;
        const T* s_col = S + t * LD + (warp % 4) * 32 + g;
        // not unrolled: unrolled, its loads in flight spill the kernel's
        // registers (255 and 52 B of spills against 240 and none, at the
        // same speed)
#pragma unroll 1
        for (int kq = 0; kq < NB / 4; ++kq) {
            T a[4][2], p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                a[i][0] = __ldg(&a_row[i * 16 * NB + 4 * kq]);
                a[i][1] = __ldg(&a_row[(i * 16 + 8) * NB + 4 * kq]);
                if (SUB) a[i][0] = -a[i][0], a[i][1] = -a[i][1];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) p[j] = s_col[4 * kq * LD + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) dmma(&out[(i * 4 + j) * 4], a[i][0], a[i][1], p[j]);
        }
    } else {
        const int ty = tid / 16, tx = tid % 16;
#pragma unroll 4
        for (int k = 0; k < NB; ++k) {
            T a[4], p[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = __ldg(&A[(ty * 4 + i) * NB + k]);
#pragma unroll
            for (int q = 0; q < 8; ++q) p[q] = S[k * LD + (q / 4) * 64 + tx * 4 + q % 4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    if (SUB) out[h * 32 + i * 8 + q] -= a[i] * p[q];
                    else out[h * 32 + i * 8 + q] += a[i] * p[q];
                }
        }
    }
}

// The prologue: block i of batch z writes W_i = L_ii^-1 (the dataflow
// kernel's substitution on the identity) to D[z][i][0] and, for the second
// 64 rows of a block row (i odd), M_i = W_i L_i,i-1 to D[z][i][1]
template <typename T>
__global__ void __launch_bounds__(THREADS)
trsm_diag_kernel(const T* __restrict__ L, T* __restrict__ D, int m, long long ldl, long long sl,
                 int unit, int vec, int blocks) {
    constexpr int TILE = NB * LDS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ld = reinterpret_cast<T*>(smem_raw);
    T* W = Ld + TILE;
    T* Lp = W + TILE;
    const int tid = threadIdx.x, i = blockIdx.x % blocks, z = blockIdx.x / blocks;
    const int i0 = i * NB, nb = min(NB, m - i0);
    const bool fold = i & 1;
    L += z * sl;
    D += (static_cast<long long>(z) * blocks + i) * 2 * DIAG;

    load_block(Ld, L, ldl, m, i0, i0, vec, tid);
    if (fold) load_block(Lp, L, ldl, m, i0, i0 - NB, vec, tid);
    cp_commit();
    for (int e = tid; e < NB * NB; e += THREADS) W[(e / NB) * LDS + e % NB] = T(e / NB == e % NB);
    cp_wait<0>();
    __syncthreads();
    invert_block(W, Ld, nb, unit, tid);
    for (int e = tid; e < DIAG; e += THREADS) D[e] = W[(e / NB) * LDS + e % NB];
    if (fold) {
        T mt[16] = {};
        tile_product<T, false, 4, LDS>(mt, W, Lp, tid);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            int r, c;
            coords<T, 4>(e, tid, r, c);
            D[DIAG + r * NB + c] = mt[e];
        }
    }
}

// The main launch: one block per (batch, 128-column panel) walks the block
// rows in order.  Block row I (rows i0..): acc = L_I,<i0 X_<i0 - B_I on
// a WS-stage cp.async ring of L and X tiles (X as this block stored it:
// written in this launch, so staged through L2 by cp.async.cg only), then
// R = -acc staged in shared memory, X_a = W_a R_a, X_b = W_b R_b - M_b X_a.
// A block reads only what it wrote, after a barrier: no flags.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
trsm_wide_kernel(const T* __restrict__ L, const T* __restrict__ B, T* X,
                 const T* __restrict__ D, int m, int n, long long ldl, long long ldb,
                 long long ldx, long long sl, long long sb, long long sx, int panels, int vl,
                 int vx) {
    constexpr int LD = wide_ld<T>(), STAGE = wide_stage<T>();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ring = reinterpret_cast<T*>(smem_raw);
    T* S = ring;                               // after the updates: R, then X_a
    const int tid = threadIdx.x;
    const int z = blockIdx.x / panels, c0 = (blockIdx.x % panels) * WW;
    const int blocks = (m + NB - 1) / NB;
    L += z * sl;
    B += z * sb;
    X += z * sx;
    D += static_cast<long long>(z) * blocks * 2 * DIAG;

    for (int i0 = 0; i0 < m; i0 += WR) {
        T acc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            int r, c;
            wide_coords<T>(e, tid, r, c);
            acc[e] = (i0 + r < m && c0 + c < n) ? -B[static_cast<long long>(i0 + r) * ldb + c0 + c]
                                                : T(0);
        }
        const int kt = i0 / WK;
        auto load = [&](int t) {
            T* s = ring + (t % WS) * STAGE;
            load_block<T, WR, WK, WLK>(s, L, ldl, m, i0, t * WK, vl, tid);
            load_tile<T, WW, WK, LD, THREADS>(s + WR * WLK, X, 1, ldx, n, m, c0, t * WK, tid, vx);
        };
#pragma unroll
        for (int t = 0; t < WS - 1; ++t) {
            if (t < kt) load(t);
            cp_commit();
        }
        for (int t = 0; t < kt; ++t) {
            cp_wait<WS - 2>();
            __syncthreads();
            if (t + WS - 1 < kt) load(t + WS - 1);
            cp_commit();
            const T* s = ring + (t % WS) * STAGE;
            wide_update(acc, s, s + WR * WLK, tid);
        }
        cp_wait<0>();
        __syncthreads();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            int r, c;
            wide_coords<T>(e, tid, r, c);
            S[r * LD + c] = -acc[e];
            acc[e] = T(0);
        }
        __syncthreads();
        const int blk = i0 / NB;
        const bool two = blk + 1 < blocks;     // the block row has a second 64 rows
        const T* Dg = D + static_cast<long long>(blk) * 2 * DIAG;
        wide_diag<T, false>(acc, Dg, S, 0, tid);
        if (two) wide_diag<T, false>(acc, Dg + 2 * DIAG, S + NB * LD, 1, tid);
        __syncthreads();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            int r, c;
            wide_coords<T>(e, tid, r, c);
            if (r < NB) {
                S[r * LD + c] = acc[e];
                if (i0 + r < m && c0 + c < n) X[static_cast<long long>(i0 + r) * ldx + c0 + c] = acc[e];
            }
        }
        __syncthreads();
        if (two) wide_diag<T, true>(acc, Dg + 3 * DIAG, S, 1, tid);
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            int r, c;
            wide_coords<T>(e, tid, r, c);
            if (r >= NB && i0 + r < m && c0 + c < n)
                X[static_cast<long long>(i0 + r) * ldx + c0 + c] = acc[e];
        }
        __syncthreads();
    }
}

template <typename T>
int launch_wide(const void* L, const void* B, void* X, void* D, int m, int n, long long ldl,
                long long ldb, long long ldx, int batch, long long sl, long long sb, long long sx,
                int unit, cudaStream_t stream) {
    const int blocks = (m + NB - 1) / NB, panels = (n + WW - 1) / WW;
    const int vl = aligned16(L) && (ldl * sizeof(T)) % 16 == 0
                   && (batch == 1 || (sl * sizeof(T)) % 16 == 0);
    const int vx = aligned16(X) && (ldx * sizeof(T)) % 16 == 0
                   && (batch == 1 || (sx * sizeof(T)) % 16 == 0);
    const int diag_smem = 3 * NB * LDS * sizeof(T);
    int rc = set_smem(trsm_diag_kernel<T>, diag_smem);
    if (rc) return rc;
    trsm_diag_kernel<T><<<blocks * batch, THREADS, diag_smem, stream>>>(
        static_cast<const T*>(L), static_cast<T*>(D), m, ldl, sl, unit, vl, blocks);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    rc = set_smem(trsm_wide_kernel<T>, static_cast<int>(wide_smem<T>()));
    if (rc) return rc;
    trsm_wide_kernel<T><<<panels * batch, THREADS, wide_smem<T>(), stream>>>(
        static_cast<const T*>(L), static_cast<const T*>(B), static_cast<T*>(X),
        static_cast<const T*>(D), m, n, ldl, ldb, ldx, sl, sb, sx, panels, vl, vx);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X[z] = L[z]^-1 B[z] for z < batch: L is m x m lower triangular (the strict
// upper part is never read; with unit != 0 neither is the diagonal), B and X
// are m x n; unit column strides, row strides ldl/ldb/ldx and batch strides
// sl/sb/sx in elements; `flags` holds batch * ceil(n / 32) + 1 zeroed words
// (the count of published block rows of each (batch, panel) chain, then
// the ticket counter).  Returns cudaGetLastError() after the launch, -1 for a
// dtype the kernel does not take and -2 for a shape it cannot launch.
extern "C" int repro_trsm(int code, const void* L, const void* B, void* X, int m, int n,
                          long long ldl, long long ldb, long long ldx, int batch, long long sl,
                          long long sb, long long sx, int unit, void* flags, void* stream) {
    if (m <= 0 || n <= 0 || batch <= 0) return -2;
    if (static_cast<long long>((m + NB - 1) / NB) * ((n + PANEL - 1) / PANEL) * batch >= (1ll << 31))
        return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    unsigned* f = static_cast<unsigned*>(flags);
    if (code == F32)
        return launch<float>(L, B, X, m, n, ldl, ldb, ldx, batch, sl, sb, sx, unit, f, s);
    if (code == F64)
        return launch<double>(L, B, X, m, n, ldl, ldb, ldx, batch, sl, sb, sx, unit, f, s);
    return -1;
}

// The wide path of the same solve: `D` holds batch * ceil(m / 64) * 2 * 64 *
// 64 elements of the prologue's scratch (the diagonal blocks' inverses and
// the folded M_i); nothing needs zeroing.  Two launches on `stream`, the
// prologue's then the main one; returns as repro_trsm.
extern "C" int repro_trsm_wide(int code, const void* L, const void* B, void* X, void* D, int m,
                               int n, long long ldl, long long ldb, long long ldx, int batch,
                               long long sl, long long sb, long long sx, int unit, void* stream) {
    if (m <= 0 || n <= 0 || batch <= 0) return -2;
    if (static_cast<long long>((n + WW - 1) / WW) * batch >= (1ll << 31)
        || static_cast<long long>((m + NB - 1) / NB) * batch >= (1ll << 31))
        return -2;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (code == F32)
        return launch_wide<float>(L, B, X, D, m, n, ldl, ldb, ldx, batch, sl, sb, sx, unit, s);
    if (code == F64)
        return launch_wide<double>(L, B, X, D, m, n, ldl, ldb, ldx, batch, sl, sb, sx, unit, s);
    return -1;
}
