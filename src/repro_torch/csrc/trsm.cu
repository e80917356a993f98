// Triangular solve L X = B for Hopper (sm_90a) in one launch, plain C
// interface.
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
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t saddr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES global -> shared, or zeros when !valid (src-size 0)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(saddr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(saddr(dst)), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// the 64 x 64 tile of L at rows r0.., columns c0.. into s (stride lds),
// zero outside m x m; whole rows in 16-byte copies where `vec` allows
template <typename T>
__device__ __forceinline__ void load_tile(T* s, const T* L, long long ldl, int m, int r0, int c0,
                                          bool vec, int tid) {
    if (vec && c0 + NB <= m) {
        constexpr int PER = 16 / sizeof(T);
        for (int e = tid; e < NB * NB / PER; e += THREADS) {
            const int r = e / (NB / PER), c = (e % (NB / PER)) * PER;
            const bool ok = r0 + r < m;
            cp_async<16>(&s[r * LDS + c], ok ? &L[(r0 + r) * ldl + c0 + c] : L, ok);
        }
    } else {
        for (int e = tid; e < NB * NB; e += THREADS) {
            const int r = e / NB, c = e % NB;
            const bool ok = r0 + r < m && c0 + c < m;
            cp_async<sizeof(T)>(&s[r * LDS + c], ok ? &L[(r0 + r) * ldl + c0 + c] : L, ok);
        }
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

__device__ __forceinline__ void dmma(double* c, double a0, double a1, double b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a0), "d"(a1), "d"(b));
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
    load_tile(Ld, L, ldl, m, i0, i0, vec, tid);
    if (last >= 0) load_tile(Lt + 2 * TILE, L, ldl, m, i0, last * NB, vec, tid);
    cp_commit();
    if (last > 0) load_tile(Lt, L, ldl, m, i0, 0, vec, tid);
    cp_commit();
    if (last > 1) load_tile(Lt + TILE, L, ldl, m, i0, NB, vec, tid);
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

    // W = L_ii^-1: row i is finished, then leaves every row below; rows
    // past nb stay the identity
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
        if (j + 2 < last) load_tile(Lt + ((j + 2) % NBUF) * TILE, L, ldl, m, i0, (j + 2) * NB, vec, tid);
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
