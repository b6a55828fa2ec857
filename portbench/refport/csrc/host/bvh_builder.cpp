// Native binned-SAH BVH builder (role of reference cpu/aggregates.cpp:140-520,
// rebuilt for the TPU pipeline: emits the packed depth-first node rows +
// primitive order that ops/bvh.py uploads as device arrays).
//
// Exported C ABI (ctypes):
//   int build_bvh(const float* lo, const float* hi, int n,
//                 int max_leaf, float* nodes_out /* (2n)x8 */,
//                 int* order_out /* n */, int* n_nodes_out);
// Returns 0 on success.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BuildNode {
    float lo[3], hi[3];
    int axis = 0;
    bool leaf = false;
    int offset = 0, count = 0;   // leaf
    int left = -1, right = -1;   // interior
};

struct Ctx {
    const float* lo;
    const float* hi;
    std::vector<float> cx, cy, cz;  // centroids
    std::vector<BuildNode> nodes;
    std::vector<int> ordered;
    int ordered_count = 0;
    int max_leaf;
};

constexpr int kBuckets = 12;

inline float area(const float lo[3], const float hi[3]) {
    float d0 = std::max(hi[0] - lo[0], 0.f);
    float d1 = std::max(hi[1] - lo[1], 0.f);
    float d2 = std::max(hi[2] - lo[2], 0.f);
    return 2.f * (d0 * d1 + d0 * d2 + d1 * d2);
}

inline void grow(float lo[3], float hi[3], const float* plo, const float* phi) {
    for (int k = 0; k < 3; k++) {
        lo[k] = std::min(lo[k], plo[k]);
        hi[k] = std::max(hi[k], phi[k]);
    }
}

int make_leaf(Ctx& c, int* idx, int n, const float lo[3], const float hi[3]) {
    BuildNode nd;
    std::memcpy(nd.lo, lo, 12);
    std::memcpy(nd.hi, hi, 12);
    nd.leaf = true;
    nd.offset = c.ordered_count;
    nd.count = n;
    for (int i = 0; i < n; i++) c.ordered[c.ordered_count + i] = idx[i];
    c.ordered_count += n;
    c.nodes.push_back(nd);
    return (int)c.nodes.size() - 1;
}

// iterative build with an explicit work stack to avoid deep recursion
int build(Ctx& c, int* idx, int n);

int build_range(Ctx& c, int* idx, int n) {
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n; i++) grow(lo, hi, c.lo + 3 * idx[i], c.hi + 3 * idx[i]);
    if (n <= 2) return make_leaf(c, idx, n, lo, hi);

    // centroid bounds + split axis
    float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
    const float* cs[3] = {c.cx.data(), c.cy.data(), c.cz.data()};
    for (int i = 0; i < n; i++)
        for (int k = 0; k < 3; k++) {
            float v = cs[k][idx[i]];
            clo[k] = std::min(clo[k], v);
            chi[k] = std::max(chi[k], v);
        }
    int dim = 0;
    for (int k = 1; k < 3; k++)
        if (chi[k] - clo[k] > chi[dim] - clo[dim]) dim = k;
    if (chi[dim] == clo[dim]) {
        if (n <= c.max_leaf) return make_leaf(c, idx, n, lo, hi);
        int mid = n / 2;
        BuildNode nd;
        std::memcpy(nd.lo, lo, 12);
        std::memcpy(nd.hi, hi, 12);
        nd.axis = dim;
        int self = (int)c.nodes.size();
        c.nodes.push_back(nd);
        int l = build_range(c, idx, mid);
        int r = build_range(c, idx + mid, n - mid);
        c.nodes[self].left = l;
        c.nodes[self].right = r;
        return self;
    }

    // binned SAH
    float blo[kBuckets][3], bhi[kBuckets][3];
    int cnt[kBuckets] = {0};
    for (int b = 0; b < kBuckets; b++)
        for (int k = 0; k < 3; k++) { blo[b][k] = 1e30f; bhi[b][k] = -1e30f; }
    float inv = kBuckets / (chi[dim] - clo[dim]);
    std::vector<int> bucket_of(n);
    for (int i = 0; i < n; i++) {
        int b = std::min((int)((cs[dim][idx[i]] - clo[dim]) * inv), kBuckets - 1);
        bucket_of[i] = b;
        cnt[b]++;
        grow(blo[b], bhi[b], c.lo + 3 * idx[i], c.hi + 3 * idx[i]);
    }
    // sweep costs
    float flo[kBuckets][3], fhi[kBuckets][3], rlo[kBuckets][3], rhi[kBuckets][3];
    int fcnt[kBuckets], rcnt[kBuckets];
    {
        float accl[3] = {1e30f, 1e30f, 1e30f}, acch[3] = {-1e30f, -1e30f, -1e30f};
        int acc = 0;
        for (int b = 0; b < kBuckets; b++) {
            grow(accl, acch, blo[b], bhi[b]);
            acc += cnt[b];
            std::memcpy(flo[b], accl, 12);
            std::memcpy(fhi[b], acch, 12);
            fcnt[b] = acc;
        }
        float bl[3] = {1e30f, 1e30f, 1e30f}, bh[3] = {-1e30f, -1e30f, -1e30f};
        acc = 0;
        for (int b = kBuckets - 1; b >= 0; b--) {
            grow(bl, bh, blo[b], bhi[b]);
            acc += cnt[b];
            std::memcpy(rlo[b], bl, 12);
            std::memcpy(rhi[b], bh, 12);
            rcnt[b] = acc;
        }
    }
    int best = -1;
    float best_cost = 1e30f;
    for (int b = 0; b < kBuckets - 1; b++) {
        if (fcnt[b] == 0 || rcnt[b + 1] == 0) continue;
        float cost = fcnt[b] * area(flo[b], fhi[b]) +
                     rcnt[b + 1] * area(rlo[b + 1], rhi[b + 1]);
        if (cost < best_cost) { best_cost = cost; best = b; }
    }
    float leaf_cost = (float)n;
    float split_cost = 0.5f + best_cost / std::max(area(lo, hi), 1e-12f);
    if (!(n > c.max_leaf || (best >= 0 && split_cost < leaf_cost)))
        return make_leaf(c, idx, n, lo, hi);

    int mid;
    if (best < 0) {
        mid = n / 2;
        std::nth_element(idx, idx + mid, idx + n, [&](int a, int b2) {
            return cs[dim][a] < cs[dim][b2];
        });
    } else {
        int* it = std::partition(idx, idx + n, [&](int i) {
            int b = std::min((int)((cs[dim][i] - clo[dim]) * inv), kBuckets - 1);
            return b <= best;
        });
        mid = (int)(it - idx);
        if (mid == 0 || mid == n) mid = n / 2;
    }
    BuildNode nd;
    std::memcpy(nd.lo, lo, 12);
    std::memcpy(nd.hi, hi, 12);
    nd.axis = dim;
    int self = (int)c.nodes.size();
    c.nodes.push_back(nd);
    int l = build_range(c, idx, mid);
    int r = build_range(c, idx + mid, n - mid);
    c.nodes[self].left = l;
    c.nodes[self].right = r;
    return self;
}

void flatten(const Ctx& c, int root, float* nodes_out, int* n_out) {
    // depth-first order: left child immediately follows parent
    std::vector<int> flat_index(c.nodes.size(), -1);
    std::vector<int> order;
    order.reserve(c.nodes.size());
    std::vector<int> stack{root};
    // iterative pre-order with explicit right-then-left push
    while (!stack.empty()) {
        int i = stack.back();
        stack.pop_back();
        flat_index[i] = (int)order.size();
        order.push_back(i);
        const BuildNode& nd = c.nodes[i];
        if (!nd.leaf) {
            stack.push_back(nd.right);
            stack.push_back(nd.left);
        }
    }
    // wait: plain pre-order via stack visits left-subtree fully before right
    // only if we push right first then left — done above.
    for (size_t i = 0; i < order.size(); i++) {
        const BuildNode& nd = c.nodes[order[i]];
        float* row = nodes_out + 8 * i;
        std::memcpy(row, nd.lo, 12);
        std::memcpy(row + 3, nd.hi, 12);
        if (nd.leaf) {
            row[6] = (float)nd.offset;
            row[7] = (float)((nd.count << 2) | nd.axis);
        } else {
            row[6] = (float)flat_index[nd.right];
            row[7] = (float)nd.axis;  // count == 0
        }
    }
    *n_out = (int)order.size();
}

}  // namespace

extern "C" int build_bvh(const float* lo, const float* hi, int n, int max_leaf,
                         float* nodes_out, int* order_out, int* n_nodes_out) {
    if (n <= 0) return 1;
    Ctx c;
    c.lo = lo;
    c.hi = hi;
    c.max_leaf = max_leaf;
    c.cx.resize(n);
    c.cy.resize(n);
    c.cz.resize(n);
    for (int i = 0; i < n; i++) {
        c.cx[i] = 0.5f * (lo[3 * i] + hi[3 * i]);
        c.cy[i] = 0.5f * (lo[3 * i + 1] + hi[3 * i + 1]);
        c.cz[i] = 0.5f * (lo[3 * i + 2] + hi[3 * i + 2]);
    }
    c.nodes.reserve(2 * n);
    c.ordered.resize(n);
    std::vector<int> idx(n);
    for (int i = 0; i < n; i++) idx[i] = i;
    int root = build_range(c, idx.data(), n);
    flatten(c, root, nodes_out, n_nodes_out);
    std::memcpy(order_out, c.ordered.data(), sizeof(int) * n);
    return 0;
}
