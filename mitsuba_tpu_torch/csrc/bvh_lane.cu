// Threaded-BVH traversal kernels for Hopper (sm_90a), one thread per ray.
// They replace the four Pallas TPU lane kernels of
// mitsuba_tpu/ops/pallas_bvh.py:
//   K3 lane_chunk       <- _lane_chunk               (resume, bounded)
//   K4 lane_packed      <- bvh_traverse_lane_packed  (from the root)
//   K5 lane_hbm         <- bvh_traverse_lane_hbm     (from the root, big trees)
//   K6 lane_chunk_hbm   <- _lane_chunk_hbm           (resume, big trees)
// All four compute what the TPU kernels compute: per ray the closest hit
// (t, triangle id, u, v) within (t_min, t_max), or with any_hit the first hit
// found, over a leaf_size=1 BVH whose nodes are in depth-first order with
// skip (miss) links.
//
// Design. The TPU kernels cut the node stream into pages of 128 nodes, keep
// each node component as one 128-lane row, and let a block of 1024 lanes
// gather from the page its lanes share, because Mosaic has no per-lane gather
// (pallas_bvh.py:878-893). Hopper gathers per thread, so each thread walks its
// own skip-link pointer: node = (box hit && !leaf) ? node + 1 : skip[node].
// A node is three float4s (48 bytes, node-major, one 16-byte load each):
//   lo.xyz | skip        (a leaf stores its triangle's p0 here)
//   hi.xyz | tri id      (-1 for an internal node; a leaf stores e1)
//   e2.xyz | 0           (zero on internal nodes)
// skip and tri id are exact floats below 2^24, as in the TPU page table. The
// per-node arithmetic is _sweep_lane's (pallas_bvh.py:999-1036), in its order:
// slab test against t_min and the best t so far, Moeller-Trumbore with
// 1/where(|det| > 1e-12, det, 1), a hit only for t_min < t < best. A lane's
// node sequence depends on nothing but its own state, so the result does not
// depend on the schedule: how many visits a launch makes, or how the caller
// re-sorts lanes between launches.
//
// K3 and K6 resume from per-lane state (node, t, idx, u, v) and stop after
// max_steps node visits (0: to the end); the TPU's budget counted outer page
// iterations of a 1024-lane block instead, which has no meaning here. On the
// H100 there is no VMEM/HBM split, so K5 and K6 differ from K4 and K3 only by
// the size of the tree they are given (the scene sends trees above 2.3M nodes
// to K5).
//
// What bounds it on an H100. A visit reads 32 bytes of an internal node or 48
// of a leaf and does a slab test (25 fp32 operations) or a triangle test (46,
// one a division). A ray reads 32 bytes (K4) or 48 (K3) and writes 17 or 20.
// Counting each node a launch reads once, bytes bound it: a few microseconds
// for the bunny's 262,144 rays. The kernel takes several times that, because
// each load depends on the one before (the next node needs this one), repeat
// visits are served from L1/L2, and a launch lasts as long as its slowest
// lanes (hundreds of visits where the mean is 5-40). Shared-memory treelets, a
// short stack or a wide BVH are later work.
//
// Compile with -fmad=false: the plain PyTorch versions round every operation,
// and contraction into FMAs would flip edge hits between the two.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;  // rays per block

struct Lane {
  int node;
  float t;
  int idx;
  float u;
  float v;
};

// _safe_inv_v: 1 / x, with |x| < 1e-12 replaced by +-1e-12 (sign of x < 0)
__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-12f ? (x < 0.0f ? -1e-12f : 1e-12f) : x);
}

// Walk one lane until its pointer passes the last node, its any-hit lane
// finds a hit, or max_steps visits are spent (0: no budget).
__device__ void walk(const float4* __restrict__ nodes, int n_nodes, float ox,
                     float oy, float oz, float dx, float dy, float dz,
                     float t_min, bool any_hit, int max_steps, Lane& s) {
  const float inx = safe_inv(dx), iny = safe_inv(dy), inz = safe_inv(dz);
  int steps = 0;
  while (s.node < n_nodes && (max_steps == 0 || steps < max_steps)) {
    const float4 a = __ldg(nodes + 3 * s.node);
    const float4 b = __ldg(nodes + 3 * s.node + 1);
    const int skip = static_cast<int>(a.w);
    const int tid = static_cast<int>(b.w);
    int next = skip;
    if (tid >= 0) {
      // leaf: Moeller-Trumbore on p0 = a.xyz, e1 = b.xyz, e2 = c.xyz
      const float4 c = __ldg(nodes + 3 * s.node + 2);
      const float pvx = dy * c.z - dz * c.y;
      const float pvy = dz * c.x - dx * c.z;
      const float pvz = dx * c.y - dy * c.x;
      const float det = b.x * pvx + b.y * pvy + b.z * pvz;
      const bool ok = fabsf(det) > 1e-12f;
      const float invd = 1.0f / (ok ? det : 1.0f);
      const float tvx = ox - a.x, tvy = oy - a.y, tvz = oz - a.z;
      const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * invd;
      const float qx = tvy * b.z - tvz * b.y;
      const float qy = tvz * b.x - tvx * b.z;
      const float qz = tvx * b.y - tvy * b.x;
      const float vv = (dx * qx + dy * qy + dz * qz) * invd;
      const float tt = (c.x * qx + c.y * qy + c.z * qz) * invd;
      if (ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > t_min &&
          tt < s.t) {
        s.t = tt;
        s.idx = tid;
        s.u = uu;
        s.v = vv;
      }
    } else {
      // internal node: slab test on lo = a.xyz, hi = b.xyz
      const float t0x = (a.x - ox) * inx, t1x = (b.x - ox) * inx;
      const float t0y = (a.y - oy) * iny, t1y = (b.y - oy) * iny;
      const float t0z = (a.z - oz) * inz, t1z = (b.z - oz) * inz;
      const float tnear =
          fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                fmaxf(fminf(t0z, t1z), t_min));
      const float tfar =
          fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                fminf(fmaxf(t0z, t1z), s.t));
      if (tnear <= tfar) next = s.node + 1;
    }
    s.node = next;
    ++steps;
    if (any_hit && s.idx >= 0) s.node = n_nodes;
  }
}

// K4 and K5: from the root. A dead lane (t_max <= t_min) starts retired.
__device__ void root_lane(const float4* __restrict__ nodes, int n_nodes,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ t_min,
                          const float* __restrict__ t_max, int R, bool any_hit,
                          bool* __restrict__ hit, float* __restrict__ t_out,
                          int* __restrict__ idx_out, float* __restrict__ u_out,
                          float* __restrict__ v_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float tmin = t_min[r], tmax = t_max[r];
  Lane s{tmax > tmin ? 0 : n_nodes, tmax, -1, 0.0f, 0.0f};
  walk(nodes, n_nodes, o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r],
       d[3 * r + 1], d[3 * r + 2], tmin, any_hit, 0, s);
  const bool h = s.idx >= 0;
  hit[r] = h;
  t_out[r] = h ? s.t : CUDART_INF_F;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
}

// K3 and K6: resume from (node, t, idx, u, v); rays as one array per
// component, the layout the resort loop sorts.
__device__ void chunk_lane(
    const float4* __restrict__ nodes, int n_nodes, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ t_min,
    const int* __restrict__ node_in, const float* __restrict__ t_in,
    const int* __restrict__ i_in, const float* __restrict__ u_in,
    const float* __restrict__ v_in, int R, bool any_hit, int max_steps,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ node_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  Lane s{node_in[r], t_in[r], i_in[r], u_in[r], v_in[r]};
  walk(nodes, n_nodes, ox[r], oy[r], oz[r], dx[r], dy[r], dz[r], t_min[r],
       any_hit, max_steps, s);
  t_out[r] = s.t;
  idx_out[r] = s.idx;
  u_out[r] = s.u;
  v_out[r] = s.v;
  node_out[r] = s.node;
}

// One __global__ per TPU kernel, so each has its own name in a profile.
__global__ void lane_packed_kernel(const float4* __restrict__ nodes,
                                   int n_nodes, const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   const float* __restrict__ t_min,
                                   const float* __restrict__ t_max, int R,
                                   bool any_hit, bool* hit, float* t, int* idx,
                                   float* u, float* v) {
  root_lane(nodes, n_nodes, o, d, t_min, t_max, R, any_hit, hit, t, idx, u, v);
}

__global__ void lane_hbm_kernel(const float4* __restrict__ nodes, int n_nodes,
                                const float* __restrict__ o,
                                const float* __restrict__ d,
                                const float* __restrict__ t_min,
                                const float* __restrict__ t_max, int R,
                                bool any_hit, bool* hit, float* t, int* idx,
                                float* u, float* v) {
  root_lane(nodes, n_nodes, o, d, t_min, t_max, R, any_hit, hit, t, idx, u, v);
}

__global__ void lane_chunk_kernel(
    const float4* __restrict__ nodes, int n_nodes, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* t_min, const int* node_in,
    const float* t_in, const int* i_in, const float* u_in, const float* v_in,
    int R, bool any_hit, int max_steps, float* t, int* idx, float* u,
    float* v, int* node) {
  chunk_lane(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in, t_in,
             i_in, u_in, v_in, R, any_hit, max_steps, t, idx, u, v, node);
}

__global__ void lane_chunk_hbm_kernel(
    const float4* __restrict__ nodes, int n_nodes, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* t_min, const int* node_in,
    const float* t_in, const int* i_in, const float* u_in, const float* v_in,
    int R, bool any_hit, int max_steps, float* t, int* idx, float* u,
    float* v, int* node) {
  chunk_lane(nodes, n_nodes, ox, oy, oz, dx, dy, dz, t_min, node_in, t_in,
             i_in, u_in, v_in, R, any_hit, max_steps, t, idx, u, v, node);
}

int blocks_for(int R) { return (R + THREADS - 1) / THREADS; }

}  // namespace

// C entry points, bound with ctypes. Each launches on the given stream and
// returns cudaGetLastError(), so a refused launch is seen at once. nodes is
// the (n_nodes, 12) float32 table, 16-byte aligned.
extern "C" int bvh_lane_packed(const float* nodes, int n_nodes, const float* o,
                               const float* d, const float* t_min,
                               const float* t_max, int R, int any_hit,
                               bool* hit, float* t, int* idx, float* u,
                               float* v, void* stream) {
  lane_packed_kernel<<<blocks_for(R), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, o, d, t_min, t_max, R,
      any_hit != 0, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_lane_hbm(const float* nodes, int n_nodes, const float* o,
                            const float* d, const float* t_min,
                            const float* t_max, int R, int any_hit, bool* hit,
                            float* t, int* idx, float* u, float* v,
                            void* stream) {
  lane_hbm_kernel<<<blocks_for(R), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, o, d, t_min, t_max, R,
      any_hit != 0, hit, t, idx, u, v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_lane_chunk(const float* nodes, int n_nodes, const float* ox,
                              const float* oy, const float* oz,
                              const float* dx, const float* dy,
                              const float* dz, const float* t_min,
                              const int* node_in, const float* t_in,
                              const int* i_in, const float* u_in,
                              const float* v_in, int R, int any_hit,
                              int max_steps, float* t, int* idx, float* u,
                              float* v, int* node, void* stream) {
  lane_chunk_kernel<<<blocks_for(R), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, ox, oy, oz, dx, dy, dz,
      t_min, node_in, t_in, i_in, u_in, v_in, R, any_hit != 0, max_steps, t,
      idx, u, v, node);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_lane_chunk_hbm(const float* nodes, int n_nodes,
                                  const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const float* t_min, const int* node_in,
                                  const float* t_in, const int* i_in,
                                  const float* u_in, const float* v_in, int R,
                                  int any_hit, int max_steps, float* t,
                                  int* idx, float* u, float* v, int* node,
                                  void* stream) {
  lane_chunk_hbm_kernel<<<blocks_for(R), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, ox, oy, oz, dx, dy, dz,
      t_min, node_in, t_in, i_in, u_in, v_in, R, any_hit != 0, max_steps, t,
      idx, u, v, node);
  return static_cast<int>(cudaGetLastError());
}
