// The BSGS baby-step contraction for Hopper (sm_90a).
//
// Computes, for the giant groups c of one chunk,
//   out[c, k, r, n] = (sum_b mont(babies[b, k, r, n] * pt[c, b, r, n])) mod p_r
// with babies [G, 2, l, N] and diagonals pt [C, G, l, N], int64 canonical
// residues in the Montgomery domain (R = 2^32), and out [C, 2, l, N] int64.
// Its plain version is the torch tree of `BsgsMatvec.contract`
// (ops/bsgs.py): an int64 mont_mul of the whole [C, G, 2, l, N] product,
// a sum over b, one `% p`.  The words are equal bit for bit: the tree
// reduces an exact sum once, and so does this kernel.
//
// Replaces no Pallas kernel: on the TPU the JAX package's contraction was
// XLA-fused jnp (fhe_spear_tpu/ops/bsgs.py:339-360, mont_mul and a modular
// add tree).  On the card the torch tree was ~22 int64 elementwise passes
// over the [C, G, 2, l, N] product (145 MB at C=8, G=46, l=3, N=8192),
// which the math needs only as a running sum.
//
// Bound on this card: bytes.  A call must read every diagonal word once,
// the babies once and write the output once (8 bytes a word); the
// arithmetic is a 32-bit Montgomery product and a 64-bit add a term,
// ~8 integer instructions, far below the bytes at the H100's rates.
//
// Design.
// * Loop order.  A thread owns two neighbouring positions (r, n), (r, n+1)
//   and keeps 2*C 64-bit accumulators for each.  It walks b, loading
//   babies[b, 0:2, r, n:n+2] once and each pt[c, b, r, n:n+2] once, as
//   16-byte loads in which a warp's 32 lanes cover 512 contiguous bytes.
//   So one launch reads each diagonal word once and the babies once, never
//   once per giant group: at l = 11 the babies (66 MB) do not fit in L2.
//   The diagonals are streamed (evict-first loads), so that they do not
//   push the babies, which the chunk's next launch reads again, out of L2.
// * Lazy reduction.  A residue is below p < 2^31, so only the low word of
//   each int64 is used.  A term is the Montgomery product before its
//   conditional subtraction, in [0, 2p); G terms sum exactly in 64 bits
//   (G * 2p < 2^38 at G = 46), and one `%` at the end gives the canonical
//   word the tree's mont_mul, sum and `% p` give.
// * Splitting b.  At l = 3, N = 8192 there are 12,288 position pairs, 384
//   warps for 132 SMs: too few loads in flight to fill the memory pipe.
//   The wrapper then splits the b loop over S = 2, 4 or 8 warps of a CTA
//   (b = s, s + S, ...), which reduce their partial sums through shared
//   memory at the end.  S comes from the shapes (ops/bsgs_cuda.split):
//   one algorithm whose parameters adapt, for G = 46 or 32, l = 3 or 11,
//   N = 8192 or 16384, C = 1 ... 8.
// * C is a template parameter (1 ... 8), so the accumulators live in
//   registers; the wrapper cuts a larger C into launches of at most 8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 8;
constexpr int kMaxSplit = 8;

struct Args {
    const uint4* babies;   // [G, 2, l*N/2] pairs of int64 words
    const uint4* pt;       // [C, G, l*N/2]
    const int64_t* p;      // [l]
    const int64_t* pinv;   // [l], -p^-1 mod 2^32
    uint4* out;            // [C, 2, l*N/2]
    long long pairs;       // l*N/2
    int shift;             // log2(N) - 1: the limb of pair q is q >> shift
    int G;
    int S;                 // warps that split the b loop (1, 2, 4, 8)
};

// a*b*2^-32 mod p up to one p: in [0, 2p) for a, b < p < 2^31 (the
// Montgomery product before its conditional subtraction; pinv = -p^-1)
__device__ __forceinline__ uint32_t mont_lazy(uint32_t a, uint32_t b,
                                              uint32_t p, uint32_t pinv) {
    const uint64_t t = (uint64_t)a * b;
    const uint32_t lo = (uint32_t)t;
    const uint32_t m = lo * pinv;
    // lo + (m*p mod 2^32) = 0 mod 2^32: the carry out is (lo != 0)
    return (uint32_t)(t >> 32) + __umulhi(m, p) + (lo != 0u ? 1u : 0u);
}

__device__ __forceinline__ uint4 pair(uint64_t w0, uint64_t w1) {
    return make_uint4((uint32_t)w0, (uint32_t)(w0 >> 32), (uint32_t)w1,
                      (uint32_t)(w1 >> 32));
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
bsgs_contract_kernel(const Args a) {
    extern __shared__ ulonglong2 red[];    // [kWarps][2C][32] when S > 1
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int s = warp % a.S;
    const long long q =
        ((long long)blockIdx.x * (kWarps / a.S) + warp / a.S) * 32 + lane;
    const bool active = q < a.pairs;
    const long long plane = a.pairs;
    uint64_t acc[C][2][2];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < 2; ++k) acc[c][k][0] = acc[c][k][1] = 0;
    uint32_t p = 1;
    if (active) {
        const int r = (int)(q >> a.shift);
        p = (uint32_t)a.p[r];
        const uint32_t pinv = (uint32_t)a.pinv[r];
        for (int b = s; b < a.G; b += a.S) {
            // word n in .x, word n+1 in .z (the low halves of the int64s)
            const uint4 x0 = __ldg(a.babies + (2LL * b) * plane + q);
            const uint4 x1 = __ldg(a.babies + (2LL * b + 1) * plane + q);
            uint4 w[C];
#pragma unroll
            for (int c = 0; c < C; ++c)
                w[c] = __ldcs(a.pt + ((long long)c * a.G + b) * plane + q);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                acc[c][0][0] += mont_lazy(x0.x, w[c].x, p, pinv);
                acc[c][0][1] += mont_lazy(x0.z, w[c].z, p, pinv);
                acc[c][1][0] += mont_lazy(x1.x, w[c].x, p, pinv);
                acc[c][1][1] += mont_lazy(x1.z, w[c].z, p, pinv);
            }
        }
    }
    if (a.S == 1) {
        if (active) {
#pragma unroll
            for (int c = 0; c < C; ++c)
#pragma unroll
                for (int k = 0; k < 2; ++k)
                    a.out[(2LL * c + k) * plane + q] =
                        pair(acc[c][k][0] % p, acc[c][k][1] % p);
        }
        return;
    }
    // the S warps of one tile of 32 pairs are warps t0 ... t0 + S - 1
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < 2; ++k)
            red[(warp * 2 * C + 2 * c + k) * 32 + lane] =
                make_ulonglong2(acc[c][k][0], acc[c][k][1]);
    __syncthreads();
    if (!active) return;
    const int t0 = warp - s;
    // warp s of the tile finishes outputs j = 2c + k = s, s + S, ...
    for (int j = s; j < 2 * C; j += a.S) {
        uint64_t v0 = 0, v1 = 0;
        for (int u = 0; u < a.S; ++u) {
            const ulonglong2 x = red[((t0 + u) * 2 * C + j) * 32 + lane];
            v0 += x.x;
            v1 += x.y;
        }
        a.out[(long long)j * plane + q] = pair(v0 % p, v1 % p);
    }
}

using KernelFn = void (*)(Args);

KernelFn kernel_for(int C) {
    switch (C) {
        case 1: return bsgs_contract_kernel<1>;
        case 2: return bsgs_contract_kernel<2>;
        case 3: return bsgs_contract_kernel<3>;
        case 4: return bsgs_contract_kernel<4>;
        case 5: return bsgs_contract_kernel<5>;
        case 6: return bsgs_contract_kernel<6>;
        case 7: return bsgs_contract_kernel<7>;
        case 8: return bsgs_contract_kernel<8>;
        default: return nullptr;
    }
}

int smem_bytes(int C, int S) {
    return S > 1 ? kWarps * 2 * C * 32 * (int)sizeof(ulonglong2) : 0;
}

// Raises the dynamic shared-memory limit of the kernel for C to smem
// where it needs more than the default 48 KB (C >= 7 at S > 1).
int raise_smem(int C, int smem) {
    // the limit each kernel was last raised to
    static int limit[kMaxC + 1] = {};
    if (smem <= 48 * 1024 || smem <= limit[C]) return 0;
    const cudaError_t rc = cudaFuncSetAttribute(
        (const void*)kernel_for(C),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    limit[C] = smem;
    return 0;
}

}  // namespace

extern "C" {

// out [C, 2, l, N] from babies [G, 2, l, N] and pt [C, G, l, N] (int64, 16-
// byte aligned), p and pinv [l] int64, N = 2^logn, C <= 8, S in {1, 2, 4,
// 8} with S <= G.  Returns cudaGetLastError() (or the error of the
// launch's set-up).
int fhe_bsgs_contract(const void* babies, const void* pt, const void* p,
                      const void* pinv, void* out, int C, int G, int l,
                      int logn, int S, void* stream) {
    if (C < 1 || C > kMaxC || G < 1 || l < 1 || logn < 1 || logn > 30 ||
        S < 1 || S > kMaxSplit || (S & (S - 1)) != 0 || S > G)
        return (int)cudaErrorInvalidValue;
    KernelFn kern = kernel_for(C);
    const int smem = smem_bytes(C, S);
    const int rc = raise_smem(C, smem);
    if (rc != 0) return rc;
    Args a;
    a.babies = (const uint4*)babies;
    a.pt = (const uint4*)pt;
    a.p = (const int64_t*)p;
    a.pinv = (const int64_t*)pinv;
    a.out = (uint4*)out;
    a.pairs = ((long long)l << logn) / 2;
    a.shift = logn - 1;
    a.G = G;
    a.S = S;
    const long long tiles = (a.pairs + 31) / 32;
    const int per_cta = kWarps / S;
    const long long grid = (tiles + per_cta - 1) / per_cta;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    kern<<<dim3((unsigned)grid), kThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
