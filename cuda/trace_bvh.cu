// Per-ray BVH2 traversal over cluster leaves: prosper's ray tracer on
// NVIDIA Hopper, called from JAX through the XLA foreign function
// interface (prosper_tpu/ops/trace_cuda.py builds and registers it).
//
// One thread per ray walks the per-frame cluster BVH (accel/bvh.py
// pack_nodes: bounds (N, 6) = min.xyz | max.xyz, meta (N, 3) = left |
// right | leaf cluster or -1) with an ordered short stack: both children
// are slab-tested when their parent is visited, the nearer one is
// descended and the farther one pushed with its entry distance, and a
// popped node is dropped when its entry lies past the current closest
// hit. A leaf holds one cluster; only its first tri_count[c] triangles
// are tested (the remaining slots of the 128-wide cluster are padding).
//
// Semantics follow the plain XLA tracer (ops/trace.py trace_closest /
// trace_any): Moller-Trumbore with no backface culling, a hit needs
// t_min < t < t_max, a miss returns t = t_max, tri = -1, u = v = 0, and
// the winner's t is recomputed accurately (exact_t).
//
// Inputs (all device buffers):
//   tris   (S, 12) f32  v0.xyz e1.xyz e2.xyz pad.xyz per triangle slot
//   count  (C,)    s32  live triangles per cluster
//   bounds (N, 6)  f32, meta (N, 3) s32  BVH nodes
//   mask   (C,)    s32  0 = cluster skipped (culling, blend-only passes)
//   rays   (R, 8)  f32  o.xyz t_max | d.xyz pad
//   tmin   (1,)    f32
#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackCap = 64;  // >= BVH depth + 2 (scene/world.py checks)
constexpr int kClusterPad = 128;
constexpr int kBlock = 128;
constexpr float kDetEps = 1e-10f;

struct RayIn {
  float3 o, d, inv;
  float tmin;
};

// Slab test of one node box. Returns the entry distance, or +inf when
// the box is missed or lies outside [tmin, tmax]. The exit distance is
// widened by a few ulps so rays that graze a leaf box still reach the
// triangles on its surface.
__device__ __forceinline__ float slab_enter(const float* __restrict__ b,
                                            const RayIn& r, float tmax) {
  const float tx0 = (__ldg(b + 0) - r.o.x) * r.inv.x;
  const float tx1 = (__ldg(b + 3) - r.o.x) * r.inv.x;
  const float ty0 = (__ldg(b + 1) - r.o.y) * r.inv.y;
  const float ty1 = (__ldg(b + 4) - r.o.y) * r.inv.y;
  const float tz0 = (__ldg(b + 2) - r.o.z) * r.inv.z;
  const float tz1 = (__ldg(b + 5) - r.o.z) * r.inv.z;
  const float tn =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1)) *
      1.0000005f;
  const bool hit = tn <= tf && tf >= r.tmin && tn <= tmax;
  return hit ? tn : __int_as_float(0x7f800000);
}

// Moller-Trumbore against one triangle slot (three float4 rows).
__device__ __forceinline__ bool moller(const RayIn& r, const float4 a,
                                       const float4 b, const float4 c,
                                       float tmax, float& t, float& u,
                                       float& v) {
  const float3 e1 = make_float3(a.w, b.x, b.y);
  const float3 e2 = make_float3(b.z, b.w, c.x);
  const float3 p = make_float3(r.d.y * e2.z - r.d.z * e2.y,
                               r.d.z * e2.x - r.d.x * e2.z,
                               r.d.x * e2.y - r.d.y * e2.x);
  const float det = e1.x * p.x + e1.y * p.y + e1.z * p.z;
  if (!(fabsf(det) > kDetEps)) return false;
  const float inv = 1.0f / det;
  const float3 tv = make_float3(r.o.x - a.x, r.o.y - a.y, r.o.z - a.z);
  u = (tv.x * p.x + tv.y * p.y + tv.z * p.z) * inv;
  const float3 q = make_float3(tv.y * e1.z - tv.z * e1.y,
                               tv.z * e1.x - tv.x * e1.z,
                               tv.x * e1.y - tv.y * e1.x);
  v = (r.d.x * q.x + r.d.y * q.y + r.d.z * q.z) * inv;
  t = (e2.x * q.x + e2.y * q.y + e2.z * q.z) * inv;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin && t < tmax;
}

// The plane distance t = (v0 - o) . n / (d . n), n = e1 x e2, of the
// winning triangle in float64. Moller-Trumbore's float32 t loses about
// ulp / |cos| at a grazing angle; this one is within an ulp of the exact
// value of the float inputs, as is ops/intersect.exact_hit_t, which the
// plain tracer uses, so the two tracers agree to float rounding.
__device__ __forceinline__ float exact_t(const RayIn& r, const float4 a,
                                         const float4 b, const float4 c) {
  const double e1x = a.w, e1y = b.x, e1z = b.y;
  const double e2x = b.z, e2y = b.w, e2z = c.x;
  const double nx = e1y * e2z - e1z * e2y;
  const double ny = e1z * e2x - e1x * e2z;
  const double nz = e1x * e2y - e1y * e2x;
  const double num = ((double)a.x - r.o.x) * nx + ((double)a.y - r.o.y) * ny +
                     ((double)a.z - r.o.z) * nz;
  const double den = (double)r.d.x * nx + (double)r.d.y * ny +
                     (double)r.d.z * nz;
  return static_cast<float>(num / den);
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
    trace_kernel(const float4* __restrict__ tris,
                 const int* __restrict__ count,
                 const float* __restrict__ bounds,
                 const int* __restrict__ meta,
                 const int* __restrict__ mask,
                 const float4* __restrict__ rays,
                 const float* __restrict__ tmin_ptr, int n_rays,
                 float* __restrict__ out_t, int* __restrict__ out_tri,
                 float* __restrict__ out_u, float* __restrict__ out_v,
                 int* __restrict__ out_occluded) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_rays) return;
  const float4 r0 = rays[2 * i];
  const float4 r1 = rays[2 * i + 1];
  RayIn r;
  r.o = make_float3(r0.x, r0.y, r0.z);
  r.d = make_float3(r1.x, r1.y, r1.z);
  // near-parallel axes: "inside the slab passes, outside misses"
  r.inv = make_float3(fabsf(r.d.x) > 1e-12f ? 1.0f / r.d.x : 1e30f,
                      fabsf(r.d.y) > 1e-12f ? 1.0f / r.d.y : 1e30f,
                      fabsf(r.d.z) > 1e-12f ? 1.0f / r.d.z : 1e30f);
  r.tmin = __ldg(tmin_ptr);
  float best_t = r0.w;
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool occluded = false;

  int stack_node[kStackCap];
  float stack_t[kStackCap];
  int sp = 0;
  int node = -1;
  if (best_t > r.tmin && slab_enter(bounds, r, best_t) < best_t) node = 0;

  while (node >= 0) {
    const int* m = meta + 3 * node;
    const int left = __ldg(m);
    if (left < 0) {
      const int c = __ldg(m + 2);
      if (c >= 0 && __ldg(mask + c) != 0) {
        const int n = __ldg(count + c);
        const float4* tri = tris + 3 * (c * kClusterPad);
        for (int k = 0; k < n; ++k) {
          float t, u, v;
          if (moller(r, __ldg(tri + 3 * k), __ldg(tri + 3 * k + 1),
                     __ldg(tri + 3 * k + 2), best_t, t, u, v)) {
            if (kAny) {
              occluded = true;
              break;
            }
            best_t = t;
            best_tri = c * kClusterPad + k;
            best_u = u;
            best_v = v;
          }
        }
        if (kAny && occluded) break;
      }
      node = -1;
    } else {
      const int right = __ldg(m + 1);
      const float tl = slab_enter(bounds + 6 * left, r, best_t);
      const float tr = slab_enter(bounds + 6 * right, r, best_t);
      const bool hl = tl < best_t, hr = tr < best_t;
      if (hl && hr) {
        const bool left_first = tl <= tr;
        const int far_node = left_first ? right : left;
        if (sp < kStackCap) {
          stack_node[sp] = far_node;
          stack_t[sp] = left_first ? tr : tl;
          ++sp;
        }
        node = left_first ? left : right;
        continue;
      }
      node = hl ? left : (hr ? right : -1);
    }
    while (node < 0 && sp > 0) {
      --sp;
      if (stack_t[sp] < best_t) node = stack_node[sp];
    }
  }

  if (kAny) {
    out_occluded[i] = occluded ? 1 : 0;
  } else {
    if (best_tri >= 0) {
      const float4* tri = tris + 3 * best_tri;
      best_t = exact_t(r, __ldg(tri), __ldg(tri + 1), __ldg(tri + 2));
    }
    out_t[i] = best_t;
    out_tri[i] = best_tri;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

ffi::Error check_launch() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error check_layout(const ffi::Buffer<ffi::F32>& tris,
                        const ffi::Buffer<ffi::F32>& rays) {
  if (tris.dimensions().size() != 2 || tris.dimensions()[1] != 12) {
    return ffi::Error::InvalidArgument("tris must be (S, 12) f32");
  }
  if (rays.dimensions().size() != 2 || rays.dimensions()[1] != 8) {
    return ffi::Error::InvalidArgument("rays must be (R, 8) f32");
  }
  return ffi::Error::Success();
}

int n_blocks(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

ffi::Error closest_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> tris,
                        ffi::Buffer<ffi::S32> count,
                        ffi::Buffer<ffi::F32> bounds,
                        ffi::Buffer<ffi::S32> meta,
                        ffi::Buffer<ffi::S32> mask,
                        ffi::Buffer<ffi::F32> rays,
                        ffi::Buffer<ffi::F32> tmin,
                        ffi::ResultBuffer<ffi::F32> t,
                        ffi::ResultBuffer<ffi::S32> tri,
                        ffi::ResultBuffer<ffi::F32> u,
                        ffi::ResultBuffer<ffi::F32> v) {
  ffi::Error err = check_layout(tris, rays);
  if (err.failure()) return err;
  const int n = static_cast<int>(rays.dimensions()[0]);
  if (n == 0) return ffi::Error::Success();
  trace_kernel<false><<<n_blocks(n), kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(tris.typed_data()), count.typed_data(),
      bounds.typed_data(), meta.typed_data(), mask.typed_data(),
      reinterpret_cast<const float4*>(rays.typed_data()), tmin.typed_data(),
      n, t->typed_data(), tri->typed_data(), u->typed_data(),
      v->typed_data(), nullptr);
  return check_launch();
}

ffi::Error any_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> tris,
                    ffi::Buffer<ffi::S32> count, ffi::Buffer<ffi::F32> bounds,
                    ffi::Buffer<ffi::S32> meta, ffi::Buffer<ffi::S32> mask,
                    ffi::Buffer<ffi::F32> rays, ffi::Buffer<ffi::F32> tmin,
                    ffi::ResultBuffer<ffi::S32> occluded) {
  ffi::Error err = check_layout(tris, rays);
  if (err.failure()) return err;
  const int n = static_cast<int>(rays.dimensions()[0]);
  if (n == 0) return ffi::Error::Success();
  trace_kernel<true><<<n_blocks(n), kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(tris.typed_data()), count.typed_data(),
      bounds.typed_data(), meta.typed_data(), mask.typed_data(),
      reinterpret_cast<const float4*>(rays.typed_data()), tmin.typed_data(),
      n, nullptr, nullptr, nullptr, nullptr, occluded->typed_data());
  return check_launch();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ProsperTraceClosest, closest_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(ProsperTraceAny, any_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
