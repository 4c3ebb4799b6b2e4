// Four-step negacyclic NTT / iNTT over RNS limbs for Hopper (sm_90a), with
// the DFT stages on the int8 tensor cores.
//
// Replaces the Pallas kernels of fhe_spear_tpu/core/fourstep_pallas.py:
//   fourstep_fwd_kernel <- ntt_fourstep_pallas      (pallas_call :137), K3a
//                          _ntt_fourstep_pallas_2d   (pallas_call :204), K3b
//                          _ntt_fourstep_pallas_2dio (pallas_call :268), K3c
//   fourstep_inv_kernel <- FourStepNtt.intt_mxu_b (parallel/ntt_fourstep.py),
//                          which the reference left to XLA.
// The three Pallas variants compute one function (they differ only in how
// they get past Mosaic's reshape limits), so one kernel replaces all three.
// Outputs equal FourStepNtt.ntt_mxu_b / intt_mxu_b bit for bit.
//
// What is computed.  Both directions are one pattern over a P x Q view of
// the polynomial (forward: P = n1, Q = n2; inverse: P = n2, Q = n1):
//   v[k][n]  = x[k*Q + n]             (forward: times psi^(k*Q+n), twist)
//   c[m][n]  = (sum_k Wa[m][k] * v[k][n]) * R^-1 * tw[m][n] * R^-1
//   y[m2*P + n2] = (sum_q Wb[m2][q] * c[n2][q]) * R^-1
//                                     (inverse: times psi_inv_n, untwist)
// with (Wa, tw, Wb) = (W1, tw, W2) forward and (W2i, twi, W1i) inverse.  All
// tables are Montgomery words (c * R mod p, R = 2^32, p < 2^31).  The
// result of a contraction is the unique value in [0, p) congruent to
// (sum W * X) * R^-1, so any exact computation of it is bitwise equal to
// the reference's.
//
// Limb contraction.  W and X are split into 4 unsigned 8-bit limbs (W_a, X_b,
// a, b = 0..3).  The 16 limb-pair products W_a . X_b run as
// mma.sync.m16n8k32 u8 x u8 -> s32 and accumulate into 7 shift groups
// T_s = sum_{a+b=s} W_a . X_b (s = 0..6).  A group holds at most 4 pairs, so
// at K = 128 every partial sum is below 4 * 128 * 255^2 = 33,292,800 < 2^25
// (int32 holds 2^31).  K below 32 (n1 or n2 = 8 or 16) is zero-padded to
// one k-step of 32; M and N below 16 are padded to one tile.
//
// Epilogue (CUDA cores, once per output per stage).  The groups fold into
// S = sum_s T_s * d_s with d_s = 2^(8s) mod p (seven 32 x 32 -> 64-bit
// multiply-adds), S congruent to sum W*X and below 7 * 2^25 * p < 2^32 p.
// So one Montgomery REDC, S_hi + umulhi(S_lo * pinv, p) + (S_lo != 0) =
// (S + m p) / 2^32 < 2p, and one conditional subtraction give the
// canonical (sum W*X) * R^-1: about 13 integer instructions an output,
// where the reference's recombination takes 9 mont_mul.
//
// Design.  One CTA of 16 warps per (limb row, share of the batch): CTA
// (r, g) of the grid's R x G transforms polynomials b = g, g + G, ... of
// row r, G chosen from B * R and the CTAs that fit on the card so that
// small launches spread over the SMs and large ones reuse the tables.  The
// Wa and Wb limb planes are built once on the host in the byte layout the
// fragments load (core/fourstep_cuda.py) and copied into shared memory once
// per CTA with cp.async, overlapped with the first polynomial's split pass;
// at n1 == n2 the two matrices are equal and share one copy.  Per
// polynomial: (1) the split pass reads x (coalesced along n), twists, and
// writes the 4 byte planes of v transposed ([n][k], k contiguous) with
// 16-byte stores; (2) stage 1 contracts Wa with those planes and writes the
// twiddled result c, again as byte planes [m][n], into shared memory: it
// never leaves the SM; (3) stage 2 contracts Wb with c's planes and writes
// y.  A warp's tile is 16 x 16 outputs (two n8 tiles): per k-step 8
// ldmatrix.x4 and 32 mma; at N = 8192 each stage has 16 tiles, one a warp.
// Every byte plane has a row stride of 16 bytes times an odd number, so
// ldmatrix rows, the split pass's 16-byte stores and the epilogue's 2-byte
// stores are free of bank conflicts.  Shared memory at N = 8192: 168 KB
// (one CTA per SM); at N = 16384: 216 KB.  512 threads hold 128 registers
// each (the 7 x 2 x 4 accumulators take 56).
//
// Bound on this card.  The larger of (a) the bytes: read x once and write
// y once (8 bytes a word) plus the tables, and (b) the operations: N *
// (n1 + n2) multiply-adds per polynomial, each 16 limb products on the
// int8 tensor cores (1,979 TOP/s dense, a multiply-add counted as two).
// At the main path's N = 8192 (n1 = 64, n2 = 128) (a) is the larger, by
// 1.5x.  What holds the kernel above it: the three phases of a polynomial
// (split pass, stage 1, stage 2, each ending at a barrier) run one after
// the other on an SM, so the tensor cores (mma.sync reaches about half the
// dense int8 rate) wait while the epilogues and the split pass run on the
// CUDA cores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinLogN = 7;               // N = 128
constexpr int kMaxLogN = 14;              // N = 16384
constexpr int kMinLogDim = 3;             // n1, n2 >= 8
constexpr int kMaxLogDim = 7;             // n1, n2 <= 128
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;     // 227 KB, the per-block limit
constexpr int kLimbs = 4;                 // 8-bit limbs of a 32-bit word
constexpr int kGroups = 2 * kLimbs - 1;   // shift groups 2^(8s), s = 0..6

// Byte-plane geometry: a plane of a d x k matrix has pad_rows(d) rows of
// row_stride(k) bytes (k zero-padded to a k-step of 32, plus 16 bytes so
// that the stride is 16 times an odd number).
__host__ __device__ constexpr int pad_rows(int d) { return d < 16 ? 16 : d; }
__host__ __device__ constexpr int pad_k(int k) { return k < 32 ? 32 : k; }
__host__ __device__ constexpr int row_stride(int k) { return pad_k(k) + 16; }
__host__ __device__ constexpr int plane_bytes(int d, int k) {
    return pad_rows(d) * row_stride(k);
}

struct Params {
    const int64_t* x;
    int64_t* y;
    const int32_t* rows;
    long long B;
    int R, G;                  // limb rows; CTAs per row
    int P, Q, log_q;           // view P x Q of the polynomial
    int share_w;               // Wa == Wb (n1 == n2): one copy in smem
    const uint32_t* pre;       // [L, N] twist before stage 1, or null
    const uint32_t* post;      // [L, N] untwist after stage 2, or null
    const uint32_t* tw;        // [L, P, Q] twiddles after stage 1
    const uint8_t* wa;         // [L, 4, pad_rows(P), row_stride(P)]
    const uint8_t* wb;         // [L, 4, pad_rows(Q), row_stride(Q)]
    const uint32_t* p;
    const uint32_t* pinv;      // -p^-1 mod 2^32
    const uint32_t* d;         // [L, 8]: 2^(8s) mod p, s = 0..6
};

__device__ __forceinline__ uint32_t redc(uint32_t hi, uint32_t lo,
                                         uint32_t p, uint32_t pinv) {
    // (hi * 2^32 + lo) * 2^-32 mod p for hi < p: m = lo * pinv mod 2^32
    // with pinv = -p^-1, and the carry of lo + (m * p mod 2^32) is lo != 0
    const uint32_t m = lo * pinv;
    const uint32_t r = hi + __umulhi(m, p) + (lo != 0u);     // < 2p
    return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pinv) {
    const uint64_t t = (uint64_t)a * b;
    return redc((uint32_t)(t >> 32), (uint32_t)t, p, pinv);
}

// (sum_s T_s 2^(8s)) * 2^-32 mod p, canonical, for T_s < 2^25 (see the
// top); d[s] = 2^(8s) mod p.
__device__ __forceinline__ uint32_t fold_reduce(const uint32_t (&t)[kGroups],
                                                const uint32_t (&d)[kGroups],
                                                uint32_t p, uint32_t pinv) {
    uint64_t acc = t[0];
#pragma unroll
    for (int s = 1; s < kGroups; ++s) acc += (uint64_t)t[s] * d[s];
    return redc((uint32_t)(acc >> 32), (uint32_t)acc, p, pinv);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
    return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
                 "[%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a (16x32 u8, row) . b (32x8 u8, col), s32 accumulators
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4],
                                       const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                 : "memory");
}

// Split pass: x[k*Q + n] (twisted by pre when given) -> 4 byte planes
// [n][k] of xs.  A unit is one n and KC = min(P, 16) consecutive k: KC
// coalesced loads (lanes along n), a 4x4 byte transpose per 4 words, and
// one 16-byte (8-byte at P = 8) store per plane.  KC is a template
// argument so that the KC loads of a unit carry no branch and are all in
// flight at once.
template <int KC>
__device__ __forceinline__ void split_poly(const Params& a,
                                           const int64_t* __restrict__ xp,
                                           const uint32_t* __restrict__ pre,
                                           uint8_t* xs, uint32_t p,
                                           uint32_t pinv) {
    const int P = a.P, Q = a.Q;
    const int stride = row_stride(P), plane = plane_bytes(Q, P);
    const int units = Q * (P / KC);
    for (int u = threadIdx.x; u < units; u += kThreads) {
        const int n = u & (Q - 1), k0 = (u >> a.log_q) * KC;
        uint32_t v[KC];
#pragma unroll
        for (int i = 0; i < KC; ++i) v[i] = (uint32_t)xp[(k0 + i) * Q + n];
        if (pre != nullptr) {
            uint32_t t[KC];
#pragma unroll
            for (int i = 0; i < KC; ++i) t[i] = __ldg(pre + (k0 + i) * Q + n);
#pragma unroll
            for (int i = 0; i < KC; ++i) v[i] = mont_mul(v[i], t[i], p, pinv);
        }
        uint32_t w[kLimbs][KC / 4];   // w[plane][j]: bytes of k0+4j..4j+3
#pragma unroll
        for (int j = 0; j < KC / 4; ++j) {
            const uint32_t t0 = __byte_perm(v[4 * j], v[4 * j + 1], 0x5140);
            const uint32_t t1 = __byte_perm(v[4 * j], v[4 * j + 1], 0x7362);
            const uint32_t t2 = __byte_perm(v[4 * j + 2], v[4 * j + 3], 0x5140);
            const uint32_t t3 = __byte_perm(v[4 * j + 2], v[4 * j + 3], 0x7362);
            w[0][j] = __byte_perm(t0, t2, 0x5410);
            w[1][j] = __byte_perm(t0, t2, 0x7632);
            w[2][j] = __byte_perm(t1, t3, 0x5410);
            w[3][j] = __byte_perm(t1, t3, 0x7632);
        }
        uint8_t* dst = xs + n * stride + k0;
#pragma unroll
        for (int l = 0; l < kLimbs; ++l) {
            if constexpr (KC == 16)
                *reinterpret_cast<uint4*>(dst + l * plane) =
                    make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
            else
                *reinterpret_cast<uint2*>(dst + l * plane) =
                    make_uint2(w[l][0], w[l][1]);
        }
    }
}

// C[m][n] = sum_k A[m][k] * B[n][k] over byte planes in shared memory (A:
// mr x kp, B: nr x kp, both k-contiguous with the given plane size and row
// stride), reduced to canonical words; epi(m, n, c[m][n], c[m][n+1]) for
// every valid m < mv, n < nv (n even).  Warps take 16 x 16 tiles in turn.
template <class Epi>
__device__ __forceinline__ void contract(const uint8_t* A, int a_plane,
                                         int a_stride, int mr, int kp,
                                         const uint8_t* Bm, int b_plane,
                                         int b_stride, int nr, int mv, int nv,
                                         uint32_t p, uint32_t pinv,
                                         const uint32_t (&d)[kGroups],
                                         Epi epi) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tiles_n = nr >> 4, tiles = (mr >> 4) * tiles_n;
    // ldmatrix row addresses: A's 4 matrices are (rows 0-7 | 8-15) x
    // (bytes 0-15 | 16-31) = fragment registers a0..a3; B's are n-tile 0
    // (bytes 0-15, 16-31) then n-tile 1, = b0, b1 of each n8 tile
    const uint32_t a_lane = smem_addr(A) +
                            ((lane & 7) + (lane & 8)) * a_stride +
                            (lane >> 4) * 16;
    const uint32_t b_lane = smem_addr(Bm) +
                            ((lane & 7) + ((lane >> 4) << 3)) * b_stride +
                            (lane & 8) * 2;
    const int g = lane >> 2, c2 = (lane & 3) << 1;
    for (int t = warp; t < tiles; t += kWarps) {
        const int m0 = (t / tiles_n) << 4, n0 = (t % tiles_n) << 4;
        const uint32_t ap = a_lane + m0 * a_stride;
        const uint32_t bp = b_lane + n0 * b_stride;
        uint32_t acc[kGroups][2][4];
#pragma unroll
        for (int s = 0; s < kGroups; ++s)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[s][j][i] = 0u;
        for (int k0 = 0; k0 < kp; k0 += 32) {
            uint32_t fa[kLimbs][4], fb[kLimbs][4];
#pragma unroll
            for (int l = 0; l < kLimbs; ++l) {
                ldmatrix_x4(fa[l], ap + l * a_plane + k0);
                ldmatrix_x4(fb[l], bp + l * b_plane + k0);
            }
#pragma unroll
            for (int ia = 0; ia < kLimbs; ++ia)
#pragma unroll
                for (int ib = 0; ib < kLimbs; ++ib) {
                    mma_u8(acc[ia + ib][0], fa[ia], fb[ib][0], fb[ib][1]);
                    mma_u8(acc[ia + ib][1], fa[ia], fb[ib][2], fb[ib][3]);
                }
        }
        // accumulator i of n8 tile j: row g + 8 (i >> 1), column c2 + (i & 1)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + g + 8 * h, n = n0 + 8 * j + c2;
                if (m < mv && n < nv) {
                    uint32_t t0[kGroups], t1[kGroups];
#pragma unroll
                    for (int s = 0; s < kGroups; ++s) {
                        t0[s] = acc[s][j][2 * h];
                        t1[s] = acc[s][j][2 * h + 1];
                    }
                    epi(m, n, fold_reduce(t0, d, p, pinv),
                        fold_reduce(t1, d, p, pinv));
                }
            }
    }
}

__device__ __forceinline__ void fourstep_body(const Params& a) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int P = a.P, Q = a.Q, n = P * Q;
    const int wa_bytes = kLimbs * plane_bytes(P, P);
    const int wb_bytes = kLimbs * plane_bytes(Q, Q);
    uint8_t* wa_s = smem;
    uint8_t* wb_s = a.share_w ? smem : smem + wa_bytes;
    uint8_t* xs = wb_s + wb_bytes;                       // [4][Q][P] planes
    uint8_t* cs = xs + kLimbs * plane_bytes(Q, P);       // [4][P][Q] planes

    const int r = blockIdx.x / a.G, g = blockIdx.x % a.G;
    const int limb = a.rows[r];
    const uint32_t p = a.p[limb], pinv = a.pinv[limb];
    uint32_t d[kGroups];
#pragma unroll
    for (int s = 0; s < kGroups; ++s) d[s] = a.d[limb * 8 + s];

    // stage the DFT-matrix limb planes once for every polynomial of the CTA
    {
        const uint8_t* src = a.wa + (size_t)limb * wa_bytes;
        for (int i = threadIdx.x * 16; i < wa_bytes; i += kThreads * 16)
            cp_async16(smem_addr(wa_s + i), src + i);
        if (!a.share_w) {
            src = a.wb + (size_t)limb * wb_bytes;
            for (int i = threadIdx.x * 16; i < wb_bytes; i += kThreads * 16)
                cp_async16(smem_addr(wb_s + i), src + i);
        }
    }

    const uint32_t* pre = a.pre ? a.pre + (size_t)limb * n : nullptr;
    const uint32_t* post = a.post ? a.post + (size_t)limb * n : nullptr;
    const uint32_t* tw = a.tw + (size_t)limb * n;
    const int sp = row_stride(P), sq = row_stride(Q);
    const int cs_plane = plane_bytes(P, Q);
    bool first = true;
    for (long long b = g; b < a.B; b += a.G) {
        const long long poly = b * a.R + r;
        if (P >= 16)
            split_poly<16>(a, a.x + poly * n, pre, xs, p, pinv);
        else
            split_poly<8>(a, a.x + poly * n, pre, xs, p, pinv);
        if (first) {
            cp_async_commit_wait();
            first = false;
        }
        __syncthreads();

        // stage 1: c = (Wa . v) * tw, kept in shared memory as byte planes
        contract(wa_s, plane_bytes(P, P), sp, pad_rows(P), pad_k(P), xs,
                 plane_bytes(Q, P), sp, pad_rows(Q), P, Q, p, pinv, d,
                 [&](int m, int col, uint32_t c0, uint32_t c1) {
                     const uint2 t = __ldg(
                         reinterpret_cast<const uint2*>(tw + m * Q + col));
                     c0 = mont_mul(c0, t.x, p, pinv);
                     c1 = mont_mul(c1, t.y, p, pinv);
                     uint8_t* dst = cs + m * sq + col;
#pragma unroll
                     for (int l = 0; l < kLimbs; ++l)
                         *reinterpret_cast<uint16_t*>(dst + l * cs_plane) =
                             (uint16_t)__byte_perm(c0, c1, 0x40 + 0x11 * l);
                 });
        __syncthreads();

        // stage 2: y = Wb . c (then the untwist)
        int64_t* yp = a.y + poly * n;
        contract(wb_s, plane_bytes(Q, Q), sq, pad_rows(Q), pad_k(Q), cs,
                 cs_plane, sq, pad_rows(P), Q, P, p, pinv, d,
                 [&](int m, int col, uint32_t c0, uint32_t c1) {
                     const int idx = m * P + col;
                     if (post != nullptr) {
                         const uint2 t = __ldg(
                             reinterpret_cast<const uint2*>(post + idx));
                         c0 = mont_mul(c0, t.x, p, pinv);
                         c1 = mont_mul(c1, t.y, p, pinv);
                     }
                     *reinterpret_cast<longlong2*>(yp + idx) =
                         make_longlong2((long long)c0, (long long)c1);
                 });
    }
}

__global__ void __launch_bounds__(kThreads, 1)
fourstep_fwd_kernel(const Params a) { fourstep_body(a); }

__global__ void __launch_bounds__(kThreads, 1)
fourstep_inv_kernel(const Params a) { fourstep_body(a); }

int log2_exact(int v) {
    int l = 0;
    while ((1 << l) < v) ++l;
    return (1 << l) == v ? l : -1;
}

struct Plan {
    int smem, grid, per_cta, ctas_per_sm;
    int G;
};

// Shared memory, grid and polynomials per CTA of one launch; raises the
// kernel's dynamic shared-memory limit when it needs more than before.
int make_plan(bool forward, int n1, int n2, int R, long long B, int share_w,
              Plan* pl) {
    const int l1 = log2_exact(n1), l2 = log2_exact(n2);
    if (l1 < kMinLogDim || l2 < kMinLogDim || l1 > kMaxLogDim ||
        l2 > kMaxLogDim || l1 + l2 < kMinLogN || l1 + l2 > kMaxLogN ||
        R < 1 || B < 1 || B * R > 0x7FFFFFFFLL || (share_w && n1 != n2))
        return (int)cudaErrorInvalidValue;
    const int P = forward ? n1 : n2, Q = forward ? n2 : n1;
    pl->smem = kLimbs * (plane_bytes(P, P) +
                         (share_w ? 0 : plane_bytes(Q, Q)) +
                         plane_bytes(Q, P) + plane_bytes(P, Q));
    if (pl->smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    auto kern = forward ? fourstep_fwd_kernel : fourstep_inv_kernel;
    // the dynamic shared-memory limit each kernel was last raised to
    static int limit[2] = {48 * 1024, 48 * 1024};
    int& lim = limit[forward ? 0 : 1];
    cudaError_t rc;
    if (pl->smem > lim) {
        rc = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl->smem);
        if (rc != cudaSuccess) return (int)rc;
        lim = pl->smem;
    }
    int dev = 0, sms = 0;
    if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return (int)rc;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &pl->ctas_per_sm, kern, kThreads, pl->smem);
    if (rc != cudaSuccess) return (int)rc;
    if (pl->ctas_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // CTAs per row: fill the card once, then even out polynomials per CTA
    long long G = (long long)pl->ctas_per_sm * sms / R;
    G = G < 1 ? 1 : (G > B ? B : G);
    const long long per = (B + G - 1) / G;
    G = (B + per - 1) / per;
    if (G * R > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    pl->G = (int)G;
    pl->grid = (int)(G * R);
    pl->per_cta = (int)per;
    return 0;
}

int launch(bool forward, const void* x, void* y, const void* rows, int R,
           long long B, int n1, int n2, const void* twist, const void* wa,
           const void* tw, const void* wb, const void* p, const void* pinv,
           const void* d, int share_w, void* stream) {
    Plan pl;
    const int rc = make_plan(forward, n1, n2, R, B, share_w, &pl);
    if (rc != 0) return rc;
    Params a;
    a.x = (const int64_t*)x;
    a.y = (int64_t*)y;
    a.rows = (const int32_t*)rows;
    a.B = B;
    a.R = R;
    a.G = pl.G;
    a.P = forward ? n1 : n2;
    a.Q = forward ? n2 : n1;
    a.log_q = log2_exact(a.Q);
    a.share_w = share_w;
    a.pre = forward ? (const uint32_t*)twist : nullptr;
    a.post = forward ? nullptr : (const uint32_t*)twist;
    a.tw = (const uint32_t*)tw;
    a.wa = (const uint8_t*)wa;
    a.wb = (const uint8_t*)wb;
    a.p = (const uint32_t*)p;
    a.pinv = (const uint32_t*)pinv;
    a.d = (const uint32_t*)d;
    auto kern = forward ? fourstep_fwd_kernel : fourstep_inv_kernel;
    kern<<<dim3((unsigned)pl.grid), kThreads, pl.smem, (cudaStream_t)stream>>>(
        a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward four-step transform of x [B, R, N] into y (natural bin order):
// psi [L, N], w1 / w2 limb-plane images, tw [L, n1, n2], p / pinv [L],
// d [L, 8] (2^(8s) mod p);
// share_w when w1 == w2 (n1 == n2).  Returns cudaGetLastError() (or the
// error of planning the launch).
int fhe_fourstep_fwd(const void* x, void* y, const void* rows, int R,
                     long long B, int n1, int n2, const void* psi,
                     const void* w1, const void* tw, const void* w2,
                     const void* p, const void* pinv, const void* d,
                     int share_w, void* stream) {
    return launch(true, x, y, rows, R, B, n1, n2, psi, w1, tw, w2, p, pinv,
                  d, share_w, stream);
}

// Inverse four-step transform of x [B, R, N] into y: psi_inv_n [L, N],
// w2i / w1i limb-plane images, twi [L, n2, n1].
int fhe_fourstep_inv(const void* x, void* y, const void* rows, int R,
                     long long B, int n1, int n2, const void* psi_inv_n,
                     const void* w2i, const void* twi, const void* w1i,
                     const void* p, const void* pinv, const void* d,
                     int share_w, void* stream) {
    return launch(false, x, y, rows, R, B, n1, n2, psi_inv_n, w2i, twi, w1i,
                  p, pinv, d, share_w, stream);
}

// The launch plan of a transform: out = {shared bytes per CTA, CTAs,
// polynomials per CTA (at most), CTAs per SM}.
int fhe_fourstep_plan(int forward, int n1, int n2, int R, long long B,
                      int share_w, int* out) {
    Plan pl;
    const int rc = make_plan(forward != 0, n1, n2, R, B, share_w, &pl);
    if (rc != 0) return rc;
    out[0] = pl.smem;
    out[1] = pl.grid;
    out[2] = pl.per_cta;
    out[3] = pl.ctas_per_sm;
    return 0;
}

}  // extern "C"
