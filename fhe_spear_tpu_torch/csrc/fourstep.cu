// Four-step negacyclic NTT / iNTT over RNS limbs for Hopper (sm_90a).
//
// Replaces the Pallas kernels of fhe_spear_tpu/core/fourstep_pallas.py:
//   fourstep_fwd_kernel <- ntt_fourstep_pallas      (pallas_call :137), K3a
//                          _ntt_fourstep_pallas_2d   (pallas_call :204), K3b
//                          _ntt_fourstep_pallas_2dio (pallas_call :268), K3c
//   fourstep_inv_kernel <- FourStepNtt.intt_mxu_b (parallel/ntt_fourstep.py
//                          :268-291), which the reference left to XLA.
// The three Pallas variants compute one function (they differ only in how
// they get past Mosaic's reshape limits), so one kernel replaces all three.
// Outputs equal FourStepNtt.ntt_mxu_b / intt_mxu_b bit for bit.
//
// What is computed.  With N = n1 * n2, forward:
//   v[j1][j2]  = x[j1*n2 + j2] * psi^j                       (twist)
//   a[k1][j2]  = (sum_j1 W1[k1][j1] * v[j1][j2]) * R^-1 * tw[k1][j2] * R^-1
//   y[k2*n1 + k1] = (sum_j2 W2[k2][j2] * a[k1][j2]) * R^-1    (natural order)
// and inverse (input bins X[k2][k1] = x[k2*n1 + k1]):
//   a[j2][k1]  = (sum_k2 W2i[j2][k2] * X[k2][k1]) * R^-1 * twi[j2][k1] * R^-1
//   y[j1*n2 + j2] = (sum_k1 W1i[j1][k1] * a[j2][k1]) * R^-1
//                   * psi_inv_n[j] * R^-1
// All tables are Montgomery words (c * R mod p, R = 2^32).  The reference
// contracts 7-bit limbs on the MXU and recombines them with mont_mul by
// 2^(7s); its result is the unique value in [0, p) congruent to
// (sum_k W * X) * R^-1, so any exact computation of that value is bitwise
// equal.  This kernel accumulates the exact 64-bit products W * X into a
// 64-bit sum plus a carry count (the full sum is below 2^69 for K <= 128),
// then reduces once: the part above bit 32 modulo p, then one Montgomery
// REDC (__umulhi) of the last 32 bits.  No limb split is carried over.
//
// Design (a simple first version).  One thread block per (polynomial, limb
// row).  The polynomial sits in dynamic shared memory as 32-bit words:
// buffer v [n1][n2] (N words) and the stage output a, stored transposed
// with its row padded by one word ([n2][n1 + 1] forward, [n1][n2 + 1]
// inverse) so that the stage writing it and the stage reading it are both
// free of bank conflicts.  Each thread computes whole output entries as
// modular dot products; neighbouring threads take neighbouring columns, so
// shared-memory reads are consecutive and the DFT-matrix word is the same
// across a warp (one broadcast load).  W1, W2, tw (and W1i, W2i, twi,
// psi_inv_n) are per-limb word tables in device memory, where L1/L2 hold
// them.  Two buffers need 64 KB at N = 8192 and 128 KB at N = 16384, above
// the 48 KB static limit: the launcher raises the kernel's dynamic
// shared-memory limit with cudaFuncSetAttribute before its first launch.
//
// Bound on this card.  The least time is the larger of (a) the bytes: read
// x once and write y once (8 bytes a word) plus the twist tables, and (b)
// the operations: N * (n1 + n2) modular multiply-adds per polynomial, each
// 25 7-bit limb products on the int8 tensor cores (1,979 TOP/s, a
// multiply-add counted as two operations).  At the main path's N = 8192,
// n1 = 64, n2 = 128 the two are within 2% of each other and (b) is the
// larger, so the kernel is bounded by operations.  This first design runs
// the multiply-adds on the CUDA cores (about five integer instructions
// each), so it is expected to sit far above that bound; an int8
// mma.sync / wgmma limb contraction, several polynomials per block and TMA
// staging of the DFT matrices are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinLogN = 7;               // N = 128
constexpr int kMaxLogN = 14;              // N = 16384
constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;     // 227 KB, the per-block limit

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

// Exact sum of 32x32-bit products: sum = carry * 2^64 + lo.
struct Acc {
    uint64_t lo = 0;
    uint32_t carry = 0;

    __device__ __forceinline__ void add(uint32_t a, uint32_t b) {
        const uint64_t prod = (uint64_t)a * b;
        lo += prod;
        carry += lo < prod;
    }

    // (carry * 2^64 + lo) * 2^-32 mod p, canonical
    __device__ __forceinline__ uint32_t reduce(uint32_t p,
                                               uint32_t pinv) const {
        const uint64_t top = ((uint64_t)carry << 32) | (lo >> 32);
        return redc((uint32_t)(top % p), (uint32_t)lo, p, pinv);
    }
};

// x, y: [B, R, N] int64; rows: [R] limb ids; psi: [L, N]; w1: [L, n1, n1];
// tw: [L, n1, n2]; w2: [L, n2, n2]; p, pinv: [L].  Block b*R + r
// transforms x[b, r].
__global__ void fourstep_fwd_kernel(const int64_t* __restrict__ x,
                                    int64_t* __restrict__ y,
                                    const int32_t* __restrict__ rows, int R,
                                    int log_n1, int log_n2,
                                    const uint32_t* __restrict__ psi,
                                    const uint32_t* __restrict__ w1,
                                    const uint32_t* __restrict__ tw,
                                    const uint32_t* __restrict__ w2,
                                    const uint32_t* __restrict__ P,
                                    const uint32_t* __restrict__ PINV) {
    extern __shared__ uint32_t smem[];
    const int n1 = 1 << log_n1, n2 = 1 << log_n2, n = n1 * n2;
    const int sa = n1 + 1;                 // padded row of a[j2][k1]
    uint32_t* v = smem;                    // [n1][n2]
    uint32_t* a = smem + n;                // [n2][n1 + 1]
    const long long poly = blockIdx.x;
    const int limb = rows[poly % R];
    const uint32_t p = P[limb], pinv = PINV[limb];

    const int64_t* xp = x + poly * n;
    const uint32_t* ps = psi + (size_t)limb * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
        v[j] = mont_mul((uint32_t)xp[j], __ldg(ps + j), p, pinv);  // twist
    __syncthreads();

    // column DFT + twiddle: entry i = k1 * n2 + j2
    const uint32_t* W1 = w1 + (size_t)limb * n1 * n1;
    const uint32_t* TW = tw + (size_t)limb * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j2 = i & (n2 - 1), k1 = i >> log_n2;
        const uint32_t* wr = W1 + (k1 << log_n1);
        Acc acc;
        for (int j1 = 0; j1 < n1; ++j1)
            acc.add(__ldg(wr + j1), v[(j1 << log_n2) + j2]);
        a[j2 * sa + k1] = mont_mul(acc.reduce(p, pinv), __ldg(TW + i), p,
                                   pinv);
    }
    __syncthreads();

    // row DFT: output entry i = k2 * n1 + k1 (natural four-step order)
    const uint32_t* W2 = w2 + (size_t)limb * n2 * n2;
    int64_t* yp = y + poly * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k1 = i & (n1 - 1), k2 = i >> log_n1;
        const uint32_t* wr = W2 + (k2 << log_n2);
        Acc acc;
        for (int j2 = 0; j2 < n2; ++j2)
            acc.add(__ldg(wr + j2), a[j2 * sa + k1]);
        yp[i] = acc.reduce(p, pinv);
    }
}

// x, y: [B, R, N] int64; psi_inv_n: [L, N]; w2i: [L, n2, n2];
// twi: [L, n2, n1]; w1i: [L, n1, n1].
__global__ void fourstep_inv_kernel(const int64_t* __restrict__ x,
                                    int64_t* __restrict__ y,
                                    const int32_t* __restrict__ rows, int R,
                                    int log_n1, int log_n2,
                                    const uint32_t* __restrict__ psi_inv_n,
                                    const uint32_t* __restrict__ w2i,
                                    const uint32_t* __restrict__ twi,
                                    const uint32_t* __restrict__ w1i,
                                    const uint32_t* __restrict__ P,
                                    const uint32_t* __restrict__ PINV) {
    extern __shared__ uint32_t smem[];
    const int n1 = 1 << log_n1, n2 = 1 << log_n2, n = n1 * n2;
    const int sa = n2 + 1;                 // padded row of a[k1][j2]
    uint32_t* v = smem;                    // [n2][n1]: bins k2 * n1 + k1
    uint32_t* a = smem + n;                // [n1][n2 + 1]
    const long long poly = blockIdx.x;
    const int limb = rows[poly % R];
    const uint32_t p = P[limb], pinv = PINV[limb];

    const int64_t* xp = x + poly * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) v[j] = (uint32_t)xp[j];
    __syncthreads();

    // inverse row DFT + twiddle: entry i = j2 * n1 + k1
    const uint32_t* W2 = w2i + (size_t)limb * n2 * n2;
    const uint32_t* TW = twi + (size_t)limb * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k1 = i & (n1 - 1), j2 = i >> log_n1;
        const uint32_t* wr = W2 + (j2 << log_n2);
        Acc acc;
        for (int k2 = 0; k2 < n2; ++k2)
            acc.add(__ldg(wr + k2), v[(k2 << log_n1) + k1]);
        a[k1 * sa + j2] = mont_mul(acc.reduce(p, pinv), __ldg(TW + i), p,
                                   pinv);
    }
    __syncthreads();

    // inverse column DFT + untwist: output entry i = j1 * n2 + j2
    const uint32_t* W1 = w1i + (size_t)limb * n1 * n1;
    const uint32_t* ps = psi_inv_n + (size_t)limb * n;
    int64_t* yp = y + poly * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j2 = i & (n2 - 1), j1 = i >> log_n2;
        const uint32_t* wr = W1 + (j1 << log_n1);
        Acc acc;
        for (int k1 = 0; k1 < n1; ++k1)
            acc.add(__ldg(wr + k1), a[k1 * sa + j2]);
        yp[i] = mont_mul(acc.reduce(p, pinv), __ldg(ps + i), p, pinv);
    }
}

int log2_exact(int v) {
    int l = 0;
    while ((1 << l) < v) ++l;
    return (1 << l) == v ? l : -1;
}

int launch(bool forward, const void* x, void* y, const void* rows, int R,
           long long B, int n1, int n2, const void* twist, const void* wa,
           const void* tw, const void* wb, const void* p, const void* pinv,
           void* stream) {
    const int log_n1 = log2_exact(n1), log_n2 = log2_exact(n2);
    if (log_n1 < 0 || log_n2 < 0 || log_n1 + log_n2 < kMinLogN ||
        log_n1 + log_n2 > kMaxLogN || R < 1 || B < 1 ||
        B * R > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const int n = n1 * n2;
    const int pad = forward ? n2 * (n1 + 1) : n1 * (n2 + 1);
    const int smem = (n + pad) * (int)sizeof(uint32_t);
    if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    auto kern = forward ? fourstep_fwd_kernel : fourstep_inv_kernel;
    // the dynamic shared-memory limit each kernel was last raised to
    static int limit[2] = {48 * 1024, 48 * 1024};
    int& lim = limit[forward ? 0 : 1];
    if (smem > lim) {
        const cudaError_t rc = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc != cudaSuccess) return (int)rc;
        lim = smem;
    }
    cudaStream_t st = (cudaStream_t)stream;
    kern<<<dim3((unsigned)(B * R)), kThreads, smem, st>>>(
        (const int64_t*)x, (int64_t*)y, (const int32_t*)rows, R, log_n1,
        log_n2, (const uint32_t*)twist, (const uint32_t*)wa,
        (const uint32_t*)tw, (const uint32_t*)wb, (const uint32_t*)p,
        (const uint32_t*)pinv);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward four-step transform of x [B, R, N] into y (natural bin order);
// returns cudaGetLastError() (or the error of raising the shared-memory
// limit).
int fhe_fourstep_fwd(const void* x, void* y, const void* rows, int R,
                     long long B, int n1, int n2, const void* psi,
                     const void* w1, const void* tw, const void* w2,
                     const void* p, const void* pinv, void* stream) {
    return launch(true, x, y, rows, R, B, n1, n2, psi, w1, tw, w2, p, pinv,
                  stream);
}

// Inverse four-step transform of x [B, R, N] into y.
int fhe_fourstep_inv(const void* x, void* y, const void* rows, int R,
                     long long B, int n1, int n2, const void* psi_inv_n,
                     const void* w2i, const void* twi, const void* w1i,
                     const void* p, const void* pinv, void* stream) {
    return launch(false, x, y, rows, R, B, n1, n2, psi_inv_n, w2i, twi, w1i,
                  p, pinv, stream);
}

}  // extern "C"
