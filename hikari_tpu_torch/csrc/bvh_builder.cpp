// Native BVH builder: binned SAH, flattened to stackless entry/exit arrays.
//
// The reference builds its BLAS/TLAS with the Rust `bvh` crate
// (mod.rs:458-459, instance.rs:365-371) — recursive top-down SAH on the
// host. This is the equivalent native piece (a copy of csrc/bvh_builder.cpp): a C99-ABI
// builder callable from Python via ctypes, producing the exact array
// contract of models/bvh.py (pre-order nodes; leaf entry =
// prim | 0x80000000; exit = skip pointer).
//
// Build (models/native.py does this on first use):
//   g++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o build/hikari_tpu_torch/libhikari_bvh.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Aabb {
  float mn[3], mx[3];
  void reset() {
    for (int i = 0; i < 3; i++) { mn[i] = 3.4e38f; mx[i] = -3.4e38f; }
  }
  void grow(const Aabb& o) {
    for (int i = 0; i < 3; i++) {
      mn[i] = std::min(mn[i], o.mn[i]);
      mx[i] = std::max(mx[i], o.mx[i]);
    }
  }
  void grow_point(const float* p) {
    for (int i = 0; i < 3; i++) {
      mn[i] = std::min(mn[i], p[i]);
      mx[i] = std::max(mx[i], p[i]);
    }
  }
  float half_area() const {
    float dx = std::max(0.f, mx[0] - mn[0]);
    float dy = std::max(0.f, mx[1] - mn[1]);
    float dz = std::max(0.f, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float* amin;
  const float* amax;
  std::vector<float> centroid;   // [n*3]
  std::vector<int64_t> order;    // permutation of prims (leaf order)
  std::vector<Aabb> prim_box;

  // outputs in pre-order
  float* node_min;
  float* node_max;
  uint32_t* entry;
  uint32_t* exit_;
  int64_t* first_out;
  int64_t* last_out;
  int64_t cursor = 0;

  static constexpr int kBins = 16;

  Aabb box_of(int64_t lo, int64_t hi) {  // range in `order`
    Aabb b; b.reset();
    for (int64_t i = lo; i < hi; i++) b.grow(prim_box[order[i]]);
    return b;
  }

  // Builds subtree over order[lo, hi); returns its pre-order node index.
  int64_t build(int64_t lo, int64_t hi, const Aabb& box) {
    int64_t node = cursor++;
    std::memcpy(node_min + node * 3, box.mn, 12);
    std::memcpy(node_max + node * 3, box.mx, 12);
    first_out[node] = lo;
    last_out[node] = hi - 1;

    int64_t count = hi - lo;
    if (count == 1) {
      entry[node] = uint32_t(order[lo]) | 0x80000000u;
      exit_[node] = uint32_t(node + 1);
      return node;
    }

    // centroid bounds
    Aabb cb; cb.reset();
    for (int64_t i = lo; i < hi; i++) cb.grow_point(&centroid[order[i] * 3]);

    int best_axis = -1;
    int best_bin = -1;
    float best_cost = 3.4e38f;
    Aabb best_lbox, best_rbox;
    int64_t best_lcount = 0;

    for (int axis = 0; axis < 3; axis++) {
      float lo_c = cb.mn[axis], hi_c = cb.mx[axis];
      if (hi_c - lo_c < 1e-12f) continue;
      float scale = kBins / (hi_c - lo_c);

      Aabb bins[kBins];
      int64_t counts[kBins] = {0};
      for (int b = 0; b < kBins; b++) bins[b].reset();
      for (int64_t i = lo; i < hi; i++) {
        int b = std::min<int>(kBins - 1,
                              int((centroid[order[i] * 3 + axis] - lo_c) * scale));
        counts[b]++;
        bins[b].grow(prim_box[order[i]]);
      }
      // sweep
      Aabb rboxes[kBins];
      Aabb acc; acc.reset();
      for (int b = kBins - 1; b >= 0; b--) {
        acc.grow(bins[b]);
        rboxes[b] = acc;
      }
      Aabb lacc; lacc.reset();
      int64_t lcount = 0;
      for (int b = 0; b < kBins - 1; b++) {
        lacc.grow(bins[b]);
        lcount += counts[b];
        int64_t rcount = count - lcount;
        if (lcount == 0 || rcount == 0) continue;
        float cost = lacc.half_area() * lcount + rboxes[b + 1].half_area() * rcount;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
          best_lbox = lacc;
          best_rbox = rboxes[b + 1];
          best_lcount = lcount;
        }
      }
    }

    int64_t mid;
    Aabb lbox, rbox;
    if (best_axis < 0) {
      // degenerate: median split on the widest axis
      int axis = 0;
      float w0 = cb.mx[0] - cb.mn[0], w1 = cb.mx[1] - cb.mn[1], w2 = cb.mx[2] - cb.mn[2];
      if (w1 > w0) axis = 1;
      if (w2 > ((axis == 1) ? w1 : w0)) axis = 2;
      mid = lo + count / 2;
      std::nth_element(order.begin() + lo, order.begin() + mid, order.begin() + hi,
                       [&](int64_t a, int64_t b) {
                         return centroid[a * 3 + axis] < centroid[b * 3 + axis];
                       });
      lbox = box_of(lo, mid);
      rbox = box_of(mid, hi);
    } else {
      float lo_c = cb.mn[best_axis];
      float scale = kBins / (cb.mx[best_axis] - lo_c);
      auto it = std::partition(order.begin() + lo, order.begin() + hi,
                               [&](int64_t p) {
                                 int b = std::min<int>(kBins - 1,
                                     int((centroid[p * 3 + best_axis] - lo_c) * scale));
                                 return b <= best_bin;
                               });
      mid = it - order.begin();
      if (mid == lo || mid == hi) mid = lo + count / 2;  // safety
      lbox = best_lbox;
      rbox = best_rbox;
      if (mid != lo + best_lcount) {  // partition fallback changed counts
        lbox = box_of(lo, mid);
        rbox = box_of(mid, hi);
      }
    }

    entry[node] = uint32_t(node + 1);
    build(lo, mid, lbox);
    int64_t right = build(mid, hi, rbox);
    (void)right;
    exit_[node] = uint32_t(cursor);
    return node;
  }
};

}  // namespace

extern "C" {

// Returns node count (2n-1) or -1 on error. Output arrays must hold 2n-1
// nodes; prim_order holds n entries (leaf order).
int64_t hikari_build_bvh_sah(const float* aabb_min, const float* aabb_max,
                             int64_t n, float* node_min, float* node_max,
                             uint32_t* entry, uint32_t* exit_,
                             int64_t* first, int64_t* last,
                             int64_t* prim_order) {
  if (n <= 0) return -1;
  Builder b;
  b.amin = aabb_min;
  b.amax = aabb_max;
  b.centroid.resize(n * 3);
  b.prim_box.resize(n);
  b.order.resize(n);
  for (int64_t i = 0; i < n; i++) {
    b.order[i] = i;
    for (int c = 0; c < 3; c++) {
      b.prim_box[i].mn[c] = aabb_min[i * 3 + c];
      b.prim_box[i].mx[c] = aabb_max[i * 3 + c];
      b.centroid[i * 3 + c] = 0.5f * (aabb_min[i * 3 + c] + aabb_max[i * 3 + c]);
    }
  }
  b.node_min = node_min;
  b.node_max = node_max;
  b.entry = entry;
  b.exit_ = exit_;
  b.first_out = first;
  b.last_out = last;

  Aabb root = b.box_of(0, n);
  b.build(0, n, root);
  std::memcpy(prim_order, b.order.data(), n * sizeof(int64_t));
  return b.cursor;
}

}  // extern "C"
