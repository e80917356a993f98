// Single-token attention against a decode cache on Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py:_decode_kernel (called by
// `decode_attention`, pallas_call at decode_attention.py:96).  The port's
// ops.attention sends it every decode step of a causal layer without a
// window (gemma2's global layers): one new query token per (b, query head)
// against the live prefix kv_len of a [B, Hkv, S, D] cache.
//
// What bounds it on an H100: device memory.  Each live key and value is
// read once and used for Hq/Hkv query rows: 4*Hq*D operations per key
// position against 4*Hkv*D bytes of bf16 K and V, about 2 operations per
// byte, two orders below the card's 295.  At gemma2-9b's serve shape
// (B 2, Hkv 8, D 256, kv_len 4609) that is 75.5 MB, ~0.0225 ms at
// 3.35 TB/s.  So the design exists to keep the HBM pipe full.
//
// Design.  The TPU kernel walked all key blocks of one (b, KV head) as a
// sequential grid axis with its running state in VMEM, skipping blocks past
// kv_len with pl.when.  One block per (b, KV head) would give the card
// B*Hkv = 16 blocks for 132 SMs, so the keys are split into chunks
// (kernels/decode_attention.py:plan: 15 chunks of 320 keys at the serve
// shape, 240 blocks of 256 threads, all resident at 2 per SM).  Everything
// is one launch:
//
// 1. A block streams its chunk's keys, then its values, through a 4-stage
//    ring of 16 KB tiles in shared memory (16-byte cp.async, zero-filled
//    and never read at or past kv_len): three tiles, 48 KB, in flight per
//    block.  Each lane owns 8 contiguous elements of a row (16-byte shared
//    reads; D/8 lanes per row), so every staged key row is read once and
//    used by all of the GQA group's query rows (kept in registers).
// 2. Logits go to shared memory in log2 units (log2 e folded into the
//    scale); the soft-cap is tanh(y) = 1 - 2 / (1 + 2^(2y log2 e)) on
//    ex2/rcp, as csrc/flash_attention.cu has it (~2e-5 on a capped logit).
//    With the chunk's logits all in hand, one pass takes each row's exact
//    max m and turns the logits into p = 2^(x - m) with their sum l: no
//    rescaling inside a chunk.
// 3. P.V: each thread owns 8 contiguous output columns of every row of the
//    group over unrolled rows of V; the lanes and warps that share columns
//    are summed in a fixed order, and (m, l, acc) go to float32 scratch.
// 4. The block then takes a ticket (atomicAdd after __threadfence()).  The
//    last of a (b, KV head) pair's chunks to finish combines the pair's
//    chunks in chunk order (weights 2^(m_c - max m), output acc / max(l,
//    1e-30)).  The wrapper zeroes the call's B*Hkv ticket words with one
//    memset before the launch (counted apart, as trsm's flags).  The order
//    of the arithmetic never depends on which block is last, so every call
//    gives the same bits.
//
// kv_len comes by value, or as a device int32 (a one-element tensor, as
// the reference reads it from SMEM): then the grid covers every chunk of
// S, and a block whose chunk begins at or past kv_len returns at once,
// before any load or ticket.  Both forms run the same arithmetic on the
// same chunks, so they agree bit for bit.  A device kv_len outside
// [1, S] makes the rows NaN.  Masked logits are never formed: a chunk's
// keys stop at kv_len (the reference's finite -1e30 weighs 0 there too).
// Types: bfloat16, float16 or float32 in, float32 inside, output in the
// input type.  D is 16, 32, 64, 128 or 256 and the group at most 8
// (instantiated for groups of 1, 2, 4 and 8; a group in between runs the
// next one with zero query rows); anything else returns -2.
#include "dmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;            // query rows per KV head
constexpr int STAGES = 4;
constexpr int TILE_BYTES = 16384;  // one ring stage: TK rows of K or V
constexpr int EPL = 8;             // elements of a row each lane owns
constexpr int MIN_CHUNK = 32;      // chunks are multiples of it, at most
constexpr int MAX_CHUNK = 1024;    // this (kernels/decode_attention.py)
constexpr int MAX_CHUNKS = STAGES * TILE_BYTES / 4 / MAXG;   // combine weights
constexpr float NEG_INF = -1e30f;

// dtype codes shared with kernels/attention.py and kernels/decode_attention.py
enum Code { F32 = 0, BF16 = 2, F16 = 3 };

template <typename T, int D>
struct Shape {
    static constexpr int LPK = D / EPL;                   // lanes per row
    static constexpr int RPW = 32 / LPK;                  // rows per warp step
    static constexpr int STEP = WARPS * RPW;              // rows per block step
    static constexpr int TK = TILE_BYTES / (D * static_cast<int>(sizeof(T)));   // rows per tile
    static constexpr int ELEMS = TILE_BYTES / static_cast<int>(sizeof(T));
    static constexpr int PPR = D * static_cast<int>(sizeof(T)) / 16;             // 16-byte pieces per row
    static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
    static_assert(TK % STEP == 0, "a tile is whole block steps");
    static_assert((TILE_BYTES / 16) % THREADS == 0, "a tile is whole copy rounds");
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// 8 elements from shared memory as float: two 16-byte reads for float32,
// one for the 16-bit types
__device__ __forceinline__ void load8(const float* p, float* x) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}
__device__ __forceinline__ void load8(const __half* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

struct Params {
    const void *q, *k, *v;
    void* o;
    float* part;             // per (b, query head, chunk): m, l, D floats of acc
    unsigned* tickets;       // per (b, KV head), zero at the launch
    const int* kv_len_dev;   // the live length on the device, or null
    int kv_len;              // the live length by value (kv_len_dev null)
    int S, Hkv, group, chunk;
    long long qsb, qsh, ksb, ksh, kst, vsb, vsh, vst;
    float c_lin, c_cap, c_out;   // scale log2 e; 2 log2 e scale / cap; cap log2 e
    int cap;
};

// Block (chunk c, pair b * Hkv + hk); G >= the group, a power of two.
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS, 2)
decode_kernel(const Params p) {
    using Sh = Shape<T, D>;
    constexpr int LPK = Sh::LPK, RPW = Sh::RPW, STEP = Sh::STEP, TK = Sh::TK;
    extern __shared__ __align__(16) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);
    float* ls = reinterpret_cast<float*>(smem + STAGES * TILE_BYTES);   // [G][chunk]
    __shared__ float m_s[G], l_s[G];
    __shared__ int last_s;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int sub = lane / LPK, col = (lane % LPK) * EPL;
    const int c = blockIdx.x, pair = blockIdx.y, n_grid = gridDim.x;
    const int b = pair / p.Hkv, hk = pair % p.Hkv, group = p.group;
    const long long row0 = static_cast<long long>(pair) * group;   // b * Hq + first query head
    T* O = static_cast<T*>(p.o) + row0 * D;
    const int kv_len = p.kv_len_dev != nullptr ? *p.kv_len_dev : p.kv_len;
    if (kv_len < 1 || kv_len > p.S) {
        if (c == 0)
            for (int e = tid; e < group * D; e += THREADS) store(O + e, __int_as_float(0x7fc00000));
        return;
    }
    const int chunk = p.chunk;
    const int n_live = (kv_len + chunk - 1) / chunk;
    if (c >= n_live) return;                    // past kv_len: no load, no ticket
    const int c0 = c * chunk, nk = min(chunk, kv_len - c0);
    const int ntk = (nk + TK - 1) / TK, total = 2 * ntk;
    const T* K = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh + c0 * p.kst;
    const T* V = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh + c0 * p.vst;

    // tile t < ntk holds keys [t TK, t TK + TK) of the chunk, tile ntk + t
    // the same values; rows at or past nk are zero-filled, not read
    auto load = [&](int t) {
        const bool val = t >= ntk;
        const T* src = val ? V : K;
        const long long st = val ? p.vst : p.kst;
        const int r0 = (val ? t - ntk : t) * TK;
        T* dst = ring + (t % STAGES) * Sh::ELEMS;
#pragma unroll
        for (int i = 0; i < TILE_BYTES / 16 / THREADS; ++i) {
            const int e = tid + i * THREADS, r = e / Sh::PPR, q = (e % Sh::PPR) * Sh::VEC;
            const bool ok = r0 + r < nk;
            cp_async<16>(dst + r * D + q, ok ? src + (r0 + r) * st + q : src, ok);
        }
    };
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < total) load(t);
        cp_commit();
    }

    // logits, in log2 units, into ls
    {
        float qr[G][EPL];
        const T* Q = static_cast<const T*>(p.q) + b * p.qsb + (hk * group) * p.qsh + col;
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < EPL; ++j) qr[g][j] = g < group ? to_f(Q[g * p.qsh + j]) : 0.f;
        for (int t = 0; t < ntk; ++t) {
            cp_wait<STAGES - 2>();
            __syncthreads();
            if (t + STAGES - 1 < total) load(t + STAGES - 1);
            cp_commit();
            const T* tile = ring + (t % STAGES) * Sh::ELEMS;
#pragma unroll
            for (int i = 0; i < TK / STEP; ++i) {
                const int r = i * STEP + warp * RPW + sub;
                float x[EPL], dot[G];
                load8(tile + r * D + col, x);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    dot[g] = 0.f;
#pragma unroll
                    for (int j = 0; j < EPL; ++j) dot[g] = fmaf(qr[g][j], x[j], dot[g]);
#pragma unroll
                    for (int off = LPK / 2; off > 0; off >>= 1)
                        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
                }
                const int key = t * TK + r;
                if (lane % LPK == 0 && key < nk)
#pragma unroll
                    for (int g = 0; g < G; ++g)
                        ls[g * chunk + key] = p.cap ? p.c_out - 2.f * p.c_out * rcp(1.f + ex2(dot[g] * p.c_cap))
                                                    : dot[g] * p.c_lin;
            }
        }
    }
    __syncthreads();                            // every logit of the chunk is in ls

    // each row's exact max, p = 2^(x - m) in place, and its sum
    for (int g = warp; g < G; g += WARPS) {
        float* row = ls + g * chunk;
        float m = NEG_INF;
        for (int i = lane; i < nk; i += 32) m = fmaxf(m, row[i]);
        m = warp_max(m);
        float l = 0.f;
        for (int i = lane; i < nk; i += 32) {
            const float e = ex2(row[i] - m);
            row[i] = e;
            l += e;
        }
        l = warp_sum(l);
        if (lane == 0) {
            m_s[g] = m;
            l_s[g] = l;
        }
    }

    // P.V over the value tiles (the barrier at the top of each orders ls)
    float acc[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < EPL; ++j) acc[g][j] = 0.f;
    for (int t = ntk; t < total; ++t) {
        cp_wait<STAGES - 2>();
        __syncthreads();
        if (t + STAGES - 1 < total) load(t + STAGES - 1);
        cp_commit();
        const T* tile = ring + (t % STAGES) * Sh::ELEMS;
        const int base = (t - ntk) * TK;
#pragma unroll
        for (int i = 0; i < TK / STEP; ++i) {
            const int r = i * STEP + warp * RPW + sub;
            if (base + r < nk) {
                float x[EPL];
                load8(tile + r * D + col, x);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const float w = ls[g * chunk + base + r];
#pragma unroll
                    for (int j = 0; j < EPL; ++j) acc[g][j] = fmaf(w, x[j], acc[g][j]);
                }
            }
        }
    }
    cp_wait<0>();
    __syncthreads();                            // the ring is free

    // sum the lanes of a warp that share columns, then the warps, in order
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < EPL; ++j)
#pragma unroll
            for (int off = LPK; off < 32; off <<= 1)
                acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
    float* red = reinterpret_cast<float*>(smem);                     // [WARPS][G][D]
    if (sub == 0)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < EPL; ++j) red[(warp * G + g) * D + col + j] = acc[g][j];
    __syncthreads();
    float* part = p.part + (row0 * n_grid + c) * (D + 2);
    const long long row_stride = static_cast<long long>(n_grid) * (D + 2);
    for (int e = tid; e < group * D; e += THREADS) {
        const int g = e / D, d = e % D;
        float s = red[g * D + d];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += red[(w * G + g) * D + d];
        part[g * row_stride + 2 + d] = s;
    }
    if (tid < group) {
        part[tid * row_stride] = m_s[tid];
        part[tid * row_stride + 1] = l_s[tid];
    }

    // the pair's last block combines its chunks in chunk order
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(p.tickets + pair, 1u) == static_cast<unsigned>(n_live - 1);
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    const float* pr = p.part + row0 * row_stride;
    float* wt = reinterpret_cast<float*>(smem);                      // [group][n_live]
    for (int g = warp; g < group; g += WARPS) {
        const float* pg = pr + g * row_stride;
        float m = NEG_INF;
        for (int i = lane; i < n_live; i += 32) m = fmaxf(m, __ldcg(pg + i * (D + 2)));
        m = warp_max(m);
        for (int i = lane; i < n_live; i += 32) wt[g * n_live + i] = ex2(__ldcg(pg + i * (D + 2)) - m);
    }
    __syncthreads();
    if (tid < group) {
        const float* pg = pr + tid * row_stride;
        float l = 0.f;
        for (int i = 0; i < n_live; ++i) l = fmaf(__ldcg(pg + i * (D + 2) + 1), wt[tid * n_live + i], l);
        l_s[tid] = fmaxf(l, 1e-30f);
    }
    __syncthreads();
    for (int e = tid; e < group * D; e += THREADS) {
        const int g = e / D, d = e % D;
        const float* pg = pr + g * row_stride + 2 + d;
        const float* wg = wt + g * n_live;
        float a = 0.f;
#pragma unroll 4
        for (int i = 0; i < n_live; ++i) a = fmaf(__ldcg(pg + i * (D + 2)), wg[i], a);
        store(O + e, a / l_s[g]);
    }
}

template <typename T, int D, int G>
int launch(const Params& p, int B, int n_grid, cudaStream_t stream) {
    const int smem = STAGES * TILE_BYTES + G * p.chunk * 4;
    int rc = set_smem(decode_kernel<T, D, G>, smem);
    if (rc) return rc;
    decode_kernel<T, D, G><<<dim3(n_grid, B * p.Hkv), THREADS, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(const Params& p, int B, int n_grid, cudaStream_t s) {
    if (p.group <= 1) return launch<T, D, 1>(p, B, n_grid, s);
    if (p.group <= 2) return launch<T, D, 2>(p, B, n_grid, s);
    if (p.group <= 4) return launch<T, D, 4>(p, B, n_grid, s);
    return launch<T, D, 8>(p, B, n_grid, s);
}

template <typename T>
int dispatch_d(int D, const Params& p, int B, int n_grid, cudaStream_t s) {
    switch (D) {
        case 16: return dispatch_g<T, 16>(p, B, n_grid, s);
        case 32: return dispatch_g<T, 32>(p, B, n_grid, s);
        case 64: return dispatch_g<T, 64>(p, B, n_grid, s);
        case 128: return dispatch_g<T, 128>(p, B, n_grid, s);
        case 256: return dispatch_g<T, 256>(p, B, n_grid, s);
        default: return -2;
    }
}

}  // namespace

// O = attention of one query token per (b, h) against keys [0, kv_len) of
// the cache: q is [B, Hq, 1, D], k and v [B, Hkv, S, D], each with a unit
// stride on D and the element strides of b and h (and t for k and v) in
// qs/ks/vs; k and v 16-byte aligned with strides of whole 16 bytes; O is a
// contiguous [B, Hq, 1, D] in the input type.  kv_len comes by value, or
// from the device int32 at kv_len_dev when that is not null.  The keys run
// in chunks of `chunk` (a multiple of 32, at most 1024), n_grid per (b, KV
// head): at least ceil(kv_len / chunk) for a kv_len by value, ceil(S /
// chunk) for one on the device.  part is float32 scratch of B * Hq *
// n_grid * (D + 2) values; tickets B * Hkv words, zero before the call
// (the kernel counts the pair's finished chunks there).  One launch; returns cudaGetLastError() after
// it, -1 for a dtype the kernel does not take and -2 for a shape it cannot
// launch.
extern "C" int repro_decode_attention(int code, const void* q, const void* k,
                                      const void* v, void* o, void* part,
                                      void* tickets, const int* kv_len_dev,
                                      int B, int Hq, int Hkv, int S, int D,
                                      int kv_len, int chunk, int n_grid,
                                      const long long* qs, const long long* ks,
                                      const long long* vs, float scale,
                                      float softcap, void* stream) {
    if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0) return -2;
    if (Hq % Hkv != 0 || Hq / Hkv > MAXG || B * Hkv > 65535) return -2;
    if (chunk < MIN_CHUNK || chunk > MAX_CHUNK || chunk % MIN_CHUNK != 0) return -2;
    const int need = kv_len_dev != nullptr ? (S + chunk - 1) / chunk
                                           : (kv_len >= 1 && kv_len <= S ? (kv_len + chunk - 1) / chunk : -1);
    if (need < 1 || n_grid < need || n_grid > MAX_CHUNKS) return -2;
    Params p{q, k, v, o, static_cast<float*>(part), static_cast<unsigned*>(tickets), kv_len_dev,
             kv_len, S, Hkv, Hq / Hkv, chunk, qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
             0.f, 0.f, 0.f, softcap > 0.f};
    const float log2e = 1.4426950408889634f;
    p.c_lin = scale * log2e;
    if (p.cap) {
        p.c_cap = 2.f * log2e * scale / softcap;
        p.c_out = softcap * log2e;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (code == F32) return dispatch_d<float>(D, p, B, n_grid, s);
    if (code == BF16) return dispatch_d<__nv_bfloat16>(D, p, B, n_grid, s);
    if (code == F16) return dispatch_d<__half>(D, p, B, n_grid, s);
    return -1;
}
