// Negacyclic NTT / iNTT over RNS limbs for Hopper (sm_90a).
//
// Replaces the Pallas kernels of fhe_spear_tpu/core/ntt_pallas.py:
//   ntt_fwd_kernel  <- _fwd_call (pl.pallas_call at ntt_pallas.py:144), K1
//   ntt_inv_kernel  <- _inv_call (pl.pallas_call at ntt_pallas.py:199), K2
// Outputs equal NttContext.ntt / intt of the reference bit for bit: the
// same twiddle tables, the same bit-reversed evaluation order.
//
// What is computed.  The reference's Stockham loop (core/ntt.py:305-311)
// splits each block of length 2h into lo = [0, h) and hi = [h, 2h), and
// restacks [u, v] so that u lands where lo was and v where hi was.  So the
// loop is an in-place DIF butterfly: at stage s (h = N >> (s+1)) butterfly
// k pairs i0 = (k / h) * 2h + k % h with i0 + h and uses twiddle
// fwd_tw[s][k % h].  The inverse runs the stages backwards with the
// mirror-image butterfly (u + t, u - t, t = v * inv_tw[s][k % h]).  The
// TPU kernel's lane rolls and iota masks (ntt_pallas.py:127-139, 172-185)
// exist only because Mosaic cannot reshape below 128 lanes; none of that
// is carried over.
//
// Design (a simple first version).  One thread block per (polynomial,
// limb row); the whole polynomial sits in shared memory (N <= 8192 words,
// 32 KB static); blockDim threads loop over the N/2 butterflies of each
// stage with __syncthreads() between stages.  Twiddles come from a per-limb
// concatenated table in device memory (stage s at offset N - (N >> s),
// N - 1 entries per limb).  Montgomery products use __umulhi.  I/O is the
// torch glue's int64 word (canonical residue in [0, p)); inside, 32 bits.
//
// Bound on this card.  Each polynomial is read once (8 N bytes) and written
// once (8 N bytes), plus N + N - 1 table words per limb; the arithmetic is
// (N/2) log2 N butterflies of about 15 32-bit integer instructions, which
// is below the byte time at the H100's rates, so the kernel is bounded by
// device-memory bytes.  The design keeps every intermediate stage in
// shared memory (one read and one write of device memory per transform,
// against ~2 log2 N passes for the plain torch loop).  Later work: radix-4/8
// register-resident stages, several polynomials per block, 32-bit I/O.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLogN = 13;              // N = 8192: 32 KB of shared memory
constexpr int kMaxThreads = 512;

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pinv) {
    // REDC of t = a*b < p * 2^32: (t + m p) / 2^32 with m = t * pinv mod 2^32
    const uint64_t t = (uint64_t)a * b;
    const uint32_t lo = (uint32_t)t;
    const uint32_t hi = (uint32_t)(t >> 32);
    const uint32_t m = lo * pinv;
    uint32_t r = hi + __umulhi(m, p) + (lo != 0u);
    return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
    const uint32_t r = a + b;             // < 2p < 2^32
    return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
    return a >= b ? a - b : a + p - b;
}

// x, y: [B, R, N] int64; rows: [R] limb ids; psi: [L, N]; tw: [L, N-1];
// p, pinv: [L].  Grid: B*R blocks, block b*R + r transforms x[b, r].
__global__ void ntt_fwd_kernel(const int64_t* __restrict__ x,
                               int64_t* __restrict__ y,
                               const int32_t* __restrict__ rows, int R,
                               int logn,
                               const uint32_t* __restrict__ psi,
                               const uint32_t* __restrict__ tw,
                               const uint32_t* __restrict__ P,
                               const uint32_t* __restrict__ PINV) {
    __shared__ uint32_t s[1 << kMaxLogN];
    const int n = 1 << logn;
    const long long poly = blockIdx.x;
    const int limb = rows[poly % R];
    const uint32_t p = P[limb], pinv = PINV[limb];
    const int64_t* xp = x + poly * n;
    const uint32_t* ps = psi + (size_t)limb * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
        s[j] = mont_mul((uint32_t)xp[j], ps[j], p, pinv);   // twist
    __syncthreads();
    const uint32_t* twl = tw + (size_t)limb * (n - 1);
    int off = 0;
    for (int st = 0; st < logn; ++st) {
        const int hlog = logn - 1 - st;
        const int half = 1 << hlog;
        for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
            const int j = k & (half - 1);
            const int i0 = ((k >> hlog) << (hlog + 1)) + j;
            const uint32_t lo = s[i0], hi = s[i0 + half];
            s[i0] = add_mod(lo, hi, p);
            s[i0 + half] = mont_mul(sub_mod(lo, hi, p), twl[off + j], p, pinv);
        }
        off += half;
        __syncthreads();
    }
    int64_t* yp = y + poly * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) yp[j] = s[j];
}

__global__ void ntt_inv_kernel(const int64_t* __restrict__ x,
                               int64_t* __restrict__ y,
                               const int32_t* __restrict__ rows, int R,
                               int logn,
                               const uint32_t* __restrict__ psi_inv_n,
                               const uint32_t* __restrict__ tw,
                               const uint32_t* __restrict__ P,
                               const uint32_t* __restrict__ PINV) {
    __shared__ uint32_t s[1 << kMaxLogN];
    const int n = 1 << logn;
    const long long poly = blockIdx.x;
    const int limb = rows[poly % R];
    const uint32_t p = P[limb], pinv = PINV[limb];
    const int64_t* xp = x + poly * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = (uint32_t)xp[j];
    __syncthreads();
    const uint32_t* twl = tw + (size_t)limb * (n - 1);
    for (int st = logn - 1; st >= 0; --st) {
        const int hlog = logn - 1 - st;
        const int half = 1 << hlog;
        const int off = n - (n >> st);
        for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
            const int j = k & (half - 1);
            const int i0 = ((k >> hlog) << (hlog + 1)) + j;
            const uint32_t u = s[i0];
            const uint32_t t = mont_mul(s[i0 + half], twl[off + j], p, pinv);
            s[i0] = add_mod(u, t, p);
            s[i0 + half] = sub_mod(u, t, p);
        }
        __syncthreads();
    }
    const uint32_t* ps = psi_inv_n + (size_t)limb * n;
    int64_t* yp = y + poly * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
        yp[j] = mont_mul(s[j], ps[j], p, pinv);              // untwist * 1/N
}

int launch(bool forward, const void* x, void* y, const void* rows, int R,
           long long B, int logn, const void* psi, const void* tw,
           const void* p, const void* pinv, void* stream) {
    if (logn < 1 || logn > kMaxLogN || R < 1 || B < 1 ||
        B * R > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const int threads = (1 << (logn - 1)) < kMaxThreads ? (1 << (logn - 1))
                                                         : kMaxThreads;
    const dim3 grid((unsigned)(B * R));
    cudaStream_t st = (cudaStream_t)stream;
    auto kern = forward ? ntt_fwd_kernel : ntt_inv_kernel;
    kern<<<grid, threads, 0, st>>>(
        (const int64_t*)x, (int64_t*)y, (const int32_t*)rows, R, logn,
        (const uint32_t*)psi, (const uint32_t*)tw, (const uint32_t*)p,
        (const uint32_t*)pinv);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward transform of x [B, R, N] into y; returns cudaGetLastError().
int fhe_ntt_fwd(const void* x, void* y, const void* rows, int R, long long B,
                int logn, const void* psi, const void* tw, const void* p,
                const void* pinv, void* stream) {
    return launch(true, x, y, rows, R, B, logn, psi, tw, p, pinv, stream);
}

// Inverse transform of x [B, R, N] into y; returns cudaGetLastError().
int fhe_ntt_inv(const void* x, void* y, const void* rows, int R, long long B,
                int logn, const void* psi_inv_n, const void* tw,
                const void* p, const void* pinv, void* stream) {
    return launch(false, x, y, rows, R, B, logn, psi_inv_n, tw, p, pinv,
                  stream);
}

}  // extern "C"
