// K3: all auto and cross P(k) bin sums of T rfft meshes in one pass over the
// modes, with optional Legendre pole rows.
//
// Replaces the per-pair loop of abacusutils_tpu/models/pipeline.py:
// hod_pk_fused_multi and pk_grouped_multi (one _segsum_matmul per tracer
// pair, each fed by a materialised Re(d_i conj(d_j)) mesh), whose all-pairs
// form is ops/power.py:_segsum_matmul_pairs (pairs stacked as extra LHS rows
// of one bin one-hot on the TPU's MXU, pole weights as further rows), and
// the pole sums of ops/power.py:_bin_kmu_planned (a gather by a sorted plan
// plus cumsums over k bounds). For every mode m of the (n1d, n1d, n1d/2+1)
// complex64 meshes d_0 .. d_{T-1} this kernel forms
//
//   d_t' = d_t[m] * scale / (W[ix] W[iy] W[kz])           (t < T)
//   v_ij = Re(d_i' conj(d_j'))                             (i <= j, i-major)
//
// and adds dup(kz) * v_ij to bin seg[m] of pair (i, j) (seg == nbins marks a
// mode outside every bin). dup is the Hermitian factor of K2
// (csrc/mode_bin.cu): 1 on the kz=0 plane and on the kz=n1d/2 plane of an
// even mesh, 2 elsewhere. With NP > 0 non-zero poles l_q it also adds
// (2 l_q + 1) L_{l_q}(mu) dup * v_ij to k-bin seg[m] / nmu of pole row q of
// the pair. mu^2 = kz^2 / |k|^2 is the plan's f32 value (an integer |k|^2
// rounded once, one IEEE division), and L_l is evaluated in registers as
// mu^(l mod 2) * sum_j c_j (mu^2)^j, so no per-mode pole weight is read.
//
// The fields are read through their strides (sx, sy, sz), shared by every
// field: cuFFT's rfftn output is not always C-contiguous on the card, and a
// copy of three 550^3 meshes costs three times the kernel.
//
// What bounds it on the H100: the shared-memory atomics. Each mode reads
// 8T + 4 bytes once (its T values and its bin) and the T(T+1)/2 pair
// products are formed in registers; the adds go to a private f32 histogram
// of npairs x (nbins + NP * nk) per block in shared memory (9.2 KB at 6 pairs
// x (128 + 2 x 128)), and neighbouring modes mostly share a bin, so those
// atomics serialise on-chip. Each block flushes its histogram once with
// native f64 global atomics. T (1..8) and NP (0..4) are template
// parameters, so the field, pair and pole loops unroll into registers; the
// NP = 0 form runs the same arithmetic as the kernel without poles.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxPoles = 4;
constexpr int kMaxTerms = 5;  // (mu^2)^0 .. (mu^2)^4: degrees up to 8

struct Fields {
    const float2* p[kMaxFields];
};

// L_l(mu) = mu^odd[q] * sum_j c[q][j] (mu^2)^j, scaled by norm[q] = 2 l + 1
struct Poles {
    float c[kMaxPoles][kMaxTerms];
    float norm[kMaxPoles];
    int odd[kMaxPoles];
};

template <int T, int NP>
__global__ void mode_bin_pairs_kernel(Fields f, long long sx, long long sy, long long sz,
                                      const int* __restrict__ seg,
                                      const float* __restrict__ W, float scale, int n1d,
                                      long long nmodes, int nbins, int nmu, Poles poles,
                                      double* __restrict__ out) {
    constexpr int NPAIR = T * (T + 1) / 2;
    const int nk = NP > 0 ? nbins / nmu : 0;
    const int row = nbins + NP * nk;  // one pair's histogram: bins, then pole rows
    extern __shared__ float hist[];   // [NPAIR][row]
    for (int i = threadIdx.x; i < NPAIR * row; i += blockDim.x) hist[i] = 0.f;
    __syncthreads();

    const int kzlen = n1d / 2 + 1;
    const bool even = (n1d % 2) == 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x; m < nmodes;
         m += stride) {
        const int s = seg[m];
        if (s < 0 || s >= nbins) continue;
        const int kz = (int)(m % kzlen);
        const long long r = m / kzlen;
        const int ix = (int)(r / n1d);
        const int iy = (int)(r % n1d);
        const long long at = ix * sx + iy * sy + kz * sz;
        float wd = 1.f;
        if (W != nullptr) wd = W[ix] * W[iy] * W[kz];
        float re[T], im[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
            const float2 v = f.p[t][at];
            re[t] = v.x * scale;
            im[t] = v.y * scale;
            if (W != nullptr) {
                re[t] /= wd;
                im[t] /= wd;
            }
        }
        const float dup = (kz == 0 || (even && kz == kzlen - 1)) ? 1.f : 2.f;
        float pw[NP > 0 ? NP : 1];
        if (NP > 0) {
            const int fx = ix < n1d / 2 ? ix : ix - n1d;
            const int fy = iy < n1d / 2 ? iy : iy - n1d;
            const int k2 = fx * fx + fy * fy + kz * kz;
            const float mu2 = k2 > 0 ? __fdiv_rn((float)(kz * kz), (float)k2) : 0.f;
            const float mu = sqrtf(mu2);
#pragma unroll
            for (int q = 0; q < NP; ++q) {
                float acc = 0.f, pm = 1.f;
#pragma unroll
                for (int j = 0; j < kMaxTerms; ++j) {
                    acc += poles.c[q][j] * pm;
                    pm *= mu2;
                }
                if (poles.odd[q]) acc *= mu;
                pw[q] = poles.norm[q] * acc * dup;
            }
        }
        const int kb = NP > 0 ? s / nmu : 0;
        int p = 0;
#pragma unroll
        for (int i = 0; i < T; ++i) {
#pragma unroll
            for (int j = i; j < T; ++j, ++p) {
                const float v = re[i] * re[j] + im[i] * im[j];
                float* h = hist + p * row;
                atomicAdd(h + s, dup * v);
#pragma unroll
                for (int q = 0; q < NP; ++q) atomicAdd(h + nbins + q * nk + kb, v * pw[q]);
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < NPAIR * row; i += blockDim.x) {
        const float v = hist[i];
        if (v != 0.f) atomicAdd(out + i, (double)v);
    }
}

struct Strides {
    long long x, y, z;
};

template <int T, int NP>
cudaError_t launch(const Fields& f, const Strides& st, const int* seg, const float* W,
                   float scale, int n1d, int nbins, int nmu, const Poles& poles, double* out,
                   cudaStream_t stream) {
    const long long nmodes = (long long)n1d * n1d * (n1d / 2 + 1);
    const int threads = 256;
    long long blocks = (nmodes + threads - 1) / threads;
    int dev = 0, nsm = 0;
    cudaGetDevice(&dev);
    cudaError_t e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (blocks > 8LL * nsm) blocks = 8LL * nsm;  // a grid-stride loop covers the rest
    const int nk = NP > 0 ? nbins / nmu : 0;
    const size_t smem = sizeof(float) * (size_t)(T * (T + 1) / 2) * (nbins + NP * nk);
    e = cudaFuncSetAttribute(mode_bin_pairs_kernel<T, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    mode_bin_pairs_kernel<T, NP><<<(int)blocks, threads, smem, stream>>>(
        f, st.x, st.y, st.z, seg, W, scale, n1d, nmodes, nbins, nmu, poles, out);
    return cudaGetLastError();
}

template <int T>
cudaError_t launch_poles(const Fields& f, const Strides& st, const int* seg, const float* W,
                         float scale, int n1d, int nbins, int nmu, const Poles& poles,
                         int npoles, double* out, cudaStream_t s) {
    switch (npoles) {
        case 0: return launch<T, 0>(f, st, seg, W, scale, n1d, nbins, nmu, poles, out, s);
        case 1: return launch<T, 1>(f, st, seg, W, scale, n1d, nbins, nmu, poles, out, s);
        case 2: return launch<T, 2>(f, st, seg, W, scale, n1d, nbins, nmu, poles, out, s);
        case 3: return launch<T, 3>(f, st, seg, W, scale, n1d, nbins, nmu, poles, out, s);
        case 4: return launch<T, 4>(f, st, seg, W, scale, n1d, nbins, nmu, poles, out, s);
        default: return cudaErrorInvalidValue;
    }
}

// The monomial coefficients of P_l: P_l(mu) = sum_k a_k mu^(l - 2k),
// a_k = (-1)^k C(l, k) C(2l - 2k, l) / 2^l, stored by the power of mu^2
// that remains after the factor mu^(l mod 2).
bool legendre(int l, float c[kMaxTerms]) {
    if (l < 1 || l > 2 * (kMaxTerms - 1)) return false;
    for (int j = 0; j < kMaxTerms; ++j) c[j] = 0.f;
    for (int k = 0; 2 * k <= l; ++k) {
        double a = 1.0;  // C(l, k) C(2l - 2k, l) / 2^l, exact in double for l <= 8
        for (int i = 1; i <= k; ++i) a = a * (l - k + i) / i;
        double b = 1.0;
        for (int i = 1; i <= l; ++i) b = b * (l - 2 * k + i) / i;
        a = a * b / (double)(1 << l);
        c[(l - 2 * k) / 2] = (float)((k % 2) ? -a : a);
    }
    return true;
}

}  // namespace

// ---- host entry ----

extern "C" int mode_bin_pairs(const void* const* fields, int nfields, long long sx, long long sy,
                              long long sz, const int* seg, const float* W, float scale, int n1d,
                              int nbins, int nmu, const int* pole_degrees, int npoles,
                              double* out, void* stream) {
    if (nfields < 1 || nfields > kMaxFields) return (int)cudaErrorInvalidValue;
    if (npoles < 0 || npoles > kMaxPoles) return (int)cudaErrorInvalidValue;
    if (npoles > 0 && (nmu < 1 || nbins % nmu != 0)) return (int)cudaErrorInvalidValue;
    Fields f = {};
    for (int t = 0; t < nfields; ++t) f.p[t] = (const float2*)fields[t];
    const Strides st = {sx, sy, sz};
    Poles poles = {};
    for (int q = 0; q < npoles; ++q) {
        const int l = pole_degrees[q];
        if (!legendre(l, poles.c[q])) return (int)cudaErrorInvalidValue;
        poles.norm[q] = (float)(2 * l + 1);
        poles.odd[q] = l % 2;
    }
    const cudaStream_t s = (cudaStream_t)stream;
#define K3_CASE(T) \
    case T: return (int)launch_poles<T>(f, st, seg, W, scale, n1d, nbins, nmu, poles, npoles, out, s)
    switch (nfields) {
        K3_CASE(1);
        K3_CASE(2);
        K3_CASE(3);
        K3_CASE(4);
        K3_CASE(5);
        K3_CASE(6);
        K3_CASE(7);
        default: return (int)launch_poles<8>(f, st, seg, W, scale, n1d, nbins, nmu, poles, npoles,
                                             out, s);
    }
#undef K3_CASE
}
