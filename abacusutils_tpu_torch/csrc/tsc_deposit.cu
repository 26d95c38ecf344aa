// K1: TSC or CIC deposit of brick-sorted weighted points into a periodic nmesh^3 grid.
//
// Replaces the TPU deposit abacusutils_tpu/ops/grid_pallas.py:_deposit_kernel
// (and its XLA twins ops/grid.py:paint_grouped_yb_multi + fold_ypad and, for
// CIC, ops/grid.py:_paint_3d_jit). On the TPU a cell's deposit was a one-hot
// matrix product on the MXU, fed from a padded (ncell, K) layout. Here the
// points stay in the order of one stable sort by the 3-D brick of their cell
// (ops/grid.py:stage_bricks), and each thread block takes one work item, a
// brick or a chunk of at most max_points of its points:
//
//   1. zero a shared-memory tile of the brick's bx x by x bz cells, one ghost
//      layer on each side and a margin of m cells per axis for points that
//      moved after staging: (bx+2+2mx) x (by+2+2my) x (bz+2+2mz) f32, 23,328 B
//      for a 16^3 brick without margin, 28,512 B with mz = 2;
//   2. each thread takes a contiguous run of the item's points and adds the
//      27 stencil weights with shared-memory atomics; a point whose stencil
//      leaves the tile (it moved more than the margin, or was staged with
//      other arithmetic) adds its 27 weights straight into the grid with
//      global atomics and is counted in *overflow, so any displacement is
//      right and a large one only costs speed;
//   3. flush the tile's non-zero entries with V-wide global atomics (float4
//      where 4 divides nmesh, float2 where 2 does, else float) on the aligned
//      groups of grid cells each tile row overlaps, wrapping every axis
//      periodically, so no ghost fold pass is needed.
//
// What bounds it on the H100: the bytes are few (the weight of every point,
// x, y, z of the kept ones, each grid written once: 0.14 ms at 3.35 TB/s for
// the bench step's 6e7 points), so the atomics are the limit: 27 shared adds
// per kept point, which sm_90a compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN: there is no native shared f32 add), and one global add
// (REDG.E.ADD.F32) per flushed group. The design keeps the global flush near
// 1.4 x the grid (the ghost layers; a tile of a whole z row, as a
// (x-cell, y-block) tile would be, flushes 3-6 x the grid and at nmesh = 550
// allows only two-row blocks); sizes the tile for four or more blocks an
// SM; takes any nmesh (the last brick of an axis is ragged); cuts heavy
// bricks into several items, so one dense region does not leave a block
// running alone at the end; and spreads the lanes of a warp over points far
// apart in the sorted order, so satellites of one halo, adjacent in a
// catalog ordered by host, do not contend for one address in the CAS loop.
//
// The cell index uses the _rn intrinsics at every step so nvcc cannot contract
// it into an FMA: it is then the staging key's cell bit for bit, and points
// leave their tile only when they moved.
//
// The multi-weight form (NF > 1, TSC) is the counterpart of
// abacusutils_tpu/ops/grid.py:paint_grouped_yb_multiw: NF weight columns on
// one brick-sorted point set (the ZCV advection: five bias fields on the
// Zel'dovich lattice) each deposit into their own grid, one after another
// in memory. A block keeps NF tiles, computes a point's stencil weights once
// and adds them, times each column's weight, into every tile; a null column
// is a unit weight (the 1cb field). The tiles cost NF times the shared memory
// of one, so the wrapper picks a smaller brick for NF > 1 (ops/grid.py:
// MULTI_BRICK) to keep more than one block an SM.
//
// KIND (a template parameter) is 0 for TSC and 1 for CIC. CIC uses the same
// 3-point stencil and tile (weights max(d,0), 1-|d|, max(-d,0), as
// abacusutils_tpu/ops/grid.py:_cloud_weights_cic). `wrap` (an argument) says
// whether a coordinate is first wrapped once into [0, box): the JAX
// package's TSC does so by default, its CIC does not, and tsc_parallel's
// wrap=False paints TSC unwrapped; an unwrapped cell is floor((p + offset)
// * inv_h + 0.5) of the raw coordinate, taken modulo nmesh.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
// weight columns one launch takes
constexpr int MAX_FIELDS = 5;

// the weight columns of a launch; a null column is a unit weight
struct Weights {
    const float* w[MAX_FIELDS];
};

// the brick layout of a stage (ops/grid.py:BrickPlan)
struct Bricks {
    int nmesh;
    int bx, by, bz;  // brick interior, cells
    int nby, nbz;    // bricks along y and z
    int mx, my, mz;  // margins, cells
};

__device__ __forceinline__ int floor_mod(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

// One axis of the cloud, the f32 arithmetic of ops/grid.py:_axis_cloud (an
// optional single periodic wrap, then round half up). Returns the centre
// index, not yet taken modulo nmesh.
template <int KIND>
__device__ __forceinline__ int axis_cloud(float p, float box, float offset, float inv_h,
                                          bool wrap, float w[3]) {
    if (wrap) {
        if (p >= box) p = __fsub_rn(p, box);
        if (p < 0.f) p = __fadd_rn(p, box);
    }
    const float g = __fmul_rn(__fadd_rn(p, offset), inv_h);
    const float i0 = floorf(__fadd_rn(g, 0.5f));
    const float d = __fsub_rn(i0, g);
    if (KIND == 0) {
        const float a = __fadd_rn(0.5f, d);
        const float b = __fsub_rn(0.5f, d);
        w[0] = __fmul_rn(0.5f, __fmul_rn(a, a));
        w[1] = __fsub_rn(0.75f, __fmul_rn(d, d));
        w[2] = __fmul_rn(0.5f, __fmul_rn(b, b));
    } else {
        w[0] = fmaxf(d, 0.f);
        w[1] = __fsub_rn(1.f, fabsf(d));
        w[2] = fmaxf(-d, 0.f);
    }
    return (int)i0;
}

template <int KIND, int V, int NF>
__global__ void __launch_bounds__(THREADS)
tsc_deposit_bricks_kernel(float* __restrict__ grid, size_t grid_stride,
                          const float* __restrict__ x, const float* __restrict__ y,
                          const float* __restrict__ z, Weights W, const int* __restrict__ work,
                          Bricks g, float box, float offset, int wrap, int* __restrict__ overflow) {
    extern __shared__ float tile[];
    const int brick = work[3 * blockIdx.x];
    const int begin = work[3 * blockIdx.x + 1];
    const int end = work[3 * blockIdx.x + 2];
    if (begin >= end) return;  // uniform across the block

    const int n = g.nmesh;
    // the unreduced grid cell of tile entry 0 along each axis
    const int ox = (brick / (g.nby * g.nbz)) * g.bx - 1 - g.mx;
    const int oy = ((brick / g.nbz) % g.nby) * g.by - 1 - g.my;
    const int oz = (brick % g.nbz) * g.bz - 1 - g.mz;
    const int tx = g.bx + 2 + 2 * g.mx;
    const int ty = g.by + 2 + 2 * g.my;
    const int tz = g.bz + 2 + 2 * g.mz;
    const int tile_n = tx * ty * tz;
    for (int i = threadIdx.x; i < NF * tile_n; i += THREADS) tile[i] = 0.f;
    __syncthreads();

    const float inv_h = __fdiv_rn((float)n, box);
    int over = 0;
    // each thread takes a contiguous run of the item's points, so the lanes
    // of a warp work on points far apart in the sorted order
    const int chunk = (end - begin + THREADS - 1) / THREADS;
    const int p1 = min(begin + (threadIdx.x + 1) * chunk, end);
    for (int p = begin + threadIdx.x * chunk; p < p1; ++p) {
        float wp[NF];
        bool any = false;
        for (int f = 0; f < NF; ++f) {
            wp[f] = W.w[f] ? W.w[f][p] : 1.f;
            any |= wp[f] != 0.f;
        }
        if (!any) continue;
        float wx[3], wy[3], wz[3];
        const int ix = axis_cloud<KIND>(x[p], box, offset, inv_h, wrap, wx);
        const int iy = axis_cloud<KIND>(y[p], box, offset, inv_h, wrap, wy);
        const int iz = axis_cloud<KIND>(z[p], box, offset, inv_h, wrap, wz);
        // tile entry of the stencil's first cell: entry t holds grid cell
        // (o + t) mod n, so any periodic image of the cell will do
        const int lx = floor_mod(ix - 1 - ox, n);
        const int ly = floor_mod(iy - 1 - oy, n);
        const int lz = floor_mod(iz - 1 - oz, n);
        if (lx + 2 < tx && ly + 2 < ty && lz + 2 < tz) {
            float* t0 = tile + (lx * ty + ly) * tz + lz;
            for (int a = 0; a < 3; ++a) {
                for (int b = 0; b < 3; ++b) {
                    const float wxy = __fmul_rn(wx[a], wy[b]);
                    for (int f = 0; f < NF; ++f) {
                        const float wab = __fmul_rn(wxy, wp[f]);
                        float* row = t0 + f * tile_n + (a * ty + b) * tz;
                        for (int k = 0; k < 3; ++k) atomicAdd(row + k, __fmul_rn(wab, wz[k]));
                    }
                }
            }
        } else {
            ++over;
            int gz[3];
            for (int k = 0; k < 3; ++k) gz[k] = floor_mod(iz + k - 1, n);
            for (int a = 0; a < 3; ++a) {
                const size_t gx = floor_mod(ix + a - 1, n);
                for (int b = 0; b < 3; ++b) {
                    const float wxy = __fmul_rn(wx[a], wy[b]);
                    const size_t r = (gx * n + floor_mod(iy + b - 1, n)) * n;
                    for (int f = 0; f < NF; ++f) {
                        const float wab = __fmul_rn(wxy, wp[f]);
                        float* row = grid + f * grid_stride + r;
                        for (int k = 0; k < 3; ++k) atomicAdd(row + gz[k], __fmul_rn(wab, wz[k]));
                    }
                }
            }
        }
    }
    over = __reduce_add_sync(0xffffffffu, over);
    if ((threadIdx.x & 31) == 0 && over) atomicAdd(overflow, over);
    __syncthreads();

    // flush: V-wide atomics (float4, float2 or float) on the aligned groups of
    // V grid cells that each tile row overlaps; V divides nmesh, so a group
    // never straddles the wrap and a row's start is V-aligned
    const int q0 = oz >= 0 ? oz / V : -((V - 1 - oz) / V);  // floor(oz / V)
    const int nq = (oz + tz - 1 >= 0 ? (oz + tz - 1) / V : -((V - oz - tz) / V)) - q0 + 1;
    const int per_tile = tx * ty * nq;
    for (int i = threadIdx.x; i < NF * per_tile; i += THREADS) {
        const int f = i / per_tile;
        const int r = (i % per_tile) / nq;
        const int g0 = (q0 + i % nq) * V;  // unreduced grid z of the group's first cell
        const float* row = tile + f * tile_n + r * tz;
        float v[V];
        bool any = false;
        for (int c = 0; c < V; ++c) {
            const int k = g0 + c - oz;
            v[c] = (k >= 0 && k < tz) ? row[k] : 0.f;
            any |= v[c] != 0.f;
        }
        if (!any) continue;
        const size_t gx = floor_mod(ox + r / ty, n);
        const size_t gy = floor_mod(oy + r % ty, n);
        float* dst = grid + f * grid_stride + (gx * n + gy) * n + floor_mod(g0, n);
        if constexpr (V == 4) {
            atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
        } else if constexpr (V == 2) {
            atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
        } else {
            atomicAdd(dst, v[0]);
        }
    }
}

template <int KIND, int V, int NF>
cudaError_t launch(float* grid, const float* x, const float* y, const float* z, const Weights& W,
                   const int* work, int nitems, const Bricks& g, float box, float offset,
                   int wrap, int* overflow, cudaStream_t stream) {
    const size_t smem = sizeof(float) * NF * (size_t)(g.bx + 2 + 2 * g.mx) *
                        (g.by + 2 + 2 * g.my) * (g.bz + 2 + 2 * g.mz);
    cudaError_t e = cudaFuncSetAttribute(tsc_deposit_bricks_kernel<KIND, V, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const size_t stride = (size_t)g.nmesh * g.nmesh * g.nmesh;
    tsc_deposit_bricks_kernel<KIND, V, NF>
        <<<nitems, THREADS, smem, stream>>>(grid, stride, x, y, z, W, work, g, box, offset, wrap,
                                           overflow);
    return cudaGetLastError();
}

template <int KIND, int V, int NF>
cudaError_t blocks_per_sm(int smem, int* blocks) {
    cudaError_t e = cudaFuncSetAttribute(tsc_deposit_bricks_kernel<KIND, V, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, tsc_deposit_bricks_kernel<KIND, V, NF>, THREADS, smem);
}

// the widest flush group that divides nmesh
int flush_width(int nmesh) { return nmesh % 4 == 0 ? 4 : nmesh % 2 == 0 ? 2 : 1; }

// One dispatch over the instantiated (KIND, V, NF): TSC takes 1..MAX_FIELDS
// columns, CIC one. F is called with the instance as a template argument.
template <int KIND, int V, typename F>
cudaError_t by_fields(int nf, F&& fn) {
    if (KIND == 1 && nf != 1) return cudaErrorInvalidValue;
    switch (nf) {
        case 1: return fn(std::integral_constant<int, 1>{});
        case 2: if constexpr (KIND == 0) return fn(std::integral_constant<int, 2>{}); break;
        case 3: if constexpr (KIND == 0) return fn(std::integral_constant<int, 3>{}); break;
        case 4: if constexpr (KIND == 0) return fn(std::integral_constant<int, 4>{}); break;
        case 5: if constexpr (KIND == 0) return fn(std::integral_constant<int, 5>{}); break;
    }
    return cudaErrorInvalidValue;
}

template <int KIND, typename F>
cudaError_t by_width(int nmesh, int nf, F&& fn) {
    switch (flush_width(nmesh)) {
        case 4:
            return by_fields<KIND, 4>(nf, [&](auto c) {
                return fn(std::integral_constant<int, 4>{}, c); });
        case 2:
            return by_fields<KIND, 2>(nf, [&](auto c) {
                return fn(std::integral_constant<int, 2>{}, c); });
        default:
            return by_fields<KIND, 1>(nf, [&](auto c) {
                return fn(std::integral_constant<int, 1>{}, c); });
    }
}

template <typename F>
cudaError_t by_instance(int kind, int nmesh, int nf, F&& fn) {
    switch (kind) {
        case 0: return by_width<0>(nmesh, nf, [&](auto v, auto c) {
            return fn(std::integral_constant<int, 0>{}, v, c); });
        case 1: return by_width<1>(nmesh, nf, [&](auto v, auto c) {
            return fn(std::integral_constant<int, 1>{}, v, c); });
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// ---- host entries ----

// grid: nf grids of nmesh^3 one after another; w: nf weight column pointers
// (host array; a null entry is a unit weight); kind: 0 TSC (nf 1..5), 1 CIC
// (nf 1); wrap: 1 wraps each coordinate once into [0, box)
extern "C" int tsc_deposit_bricks(float* grid, const float* x, const float* y, const float* z,
                                  const float* const* w, int nf, const int* work, int nitems,
                                  int nmesh, int bx, int by, int bz, int mx, int my, int mz,
                                  float box, float offset, int kind, int wrap, int* overflow,
                                  void* stream) {
    if (nf < 1 || nf > MAX_FIELDS) return (int)cudaErrorInvalidValue;
    const Bricks g{nmesh, bx, by, bz, (nmesh + by - 1) / by, (nmesh + bz - 1) / bz, mx, my, mz};
    Weights W{};
    for (int f = 0; f < nf; ++f) W.w[f] = w[f];
    const cudaStream_t s = (cudaStream_t)stream;
    return (int)by_instance(kind, nmesh, nf, [&](auto k, auto v, auto c) {
        return launch<decltype(k)::value, decltype(v)::value, decltype(c)::value>(
            grid, x, y, z, W, work, nitems, g, box, offset, wrap, overflow, s);
    });
}

// Resident blocks an SM can hold for nf tiles of `smem` bytes in all
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int tsc_deposit_blocks_per_sm(int kind, int nmesh, int nf, int smem, int* blocks) {
    return (int)by_instance(kind, nmesh, nf, [&](auto k, auto v, auto c) {
        return blocks_per_sm<decltype(k)::value, decltype(v)::value, decltype(c)::value>(
            smem, blocks);
    });
}
