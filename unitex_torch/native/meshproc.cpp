// Native mesh-processing kernels (host side).
//
// TPU-native equivalents of the reference's native host components:
//  * quadric edge-collapse decimation — the capability of open3d's
//    simplify_quadric_decimation used by the mesh preprocessor
//    (reference texturetools/geometry/uv/uv_atlas.py:56-60);
//    the Python fallback in geometry/process.py is the parity oracle.
//  * farthest point sampling — the fpsample dependency
//    (reference pipeline.py:14, 390-401).
//
// Plain C ABI for ctypes.  Build: g++ -O3 -march=native -shared -fPIC.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
    Vec3 operator+(const Vec3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator-(const Vec3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
    double dot(const Vec3 &o) const { return x * o.x + y * o.y + z * o.z; }
    Vec3 cross(const Vec3 &o) const {
        return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
    }
    double norm() const { return std::sqrt(dot(*this)); }
};

// symmetric 4x4 quadric, 10 unique coefficients
struct Quadric {
    double m[10] = {0};  // a2 ab ac ad b2 bc bd c2 cd d2
    void add_plane(double a, double b, double c, double d) {
        m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
        m[4] += b * b; m[5] += b * c; m[6] += b * d;
        m[7] += c * c; m[8] += c * d; m[9] += d * d;
    }
    Quadric operator+(const Quadric &o) const {
        Quadric q;
        for (int i = 0; i < 10; i++) q.m[i] = m[i] + o.m[i];
        return q;
    }
    double eval(const Vec3 &v) const {
        return m[0] * v.x * v.x + 2 * m[1] * v.x * v.y + 2 * m[2] * v.x * v.z +
               2 * m[3] * v.x + m[4] * v.y * v.y + 2 * m[5] * v.y * v.z +
               2 * m[6] * v.y + m[7] * v.z * v.z + 2 * m[8] * v.z + m[9];
    }
    // solve for the minimizing point; returns false if singular
    bool minimize(Vec3 &out) const {
        double A[3][3] = {{m[0], m[1], m[2]}, {m[1], m[4], m[5]}, {m[2], m[5], m[7]}};
        double b[3] = {-m[3], -m[6], -m[8]};
        // Cramer with pivot guard
        double det = A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) -
                     A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
                     A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
        if (std::fabs(det) < 1e-12) return false;
        auto det3 = [&](int col) {
            double B[3][3];
            for (int r = 0; r < 3; r++)
                for (int c = 0; c < 3; c++) B[r][c] = (c == col) ? b[r] : A[r][c];
            return B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[2][1]) -
                   B[0][1] * (B[1][0] * B[2][2] - B[1][2] * B[2][0]) +
                   B[0][2] * (B[1][0] * B[2][1] - B[1][1] * B[2][0]);
        };
        out = {det3(0) / det, det3(1) / det, det3(2) / det};
        return true;
    }
};

struct HeapEntry {
    double cost;
    int a, b;
    int64_t va, vb;  // version stamps
    Vec3 target;
    bool operator<(const HeapEntry &o) const { return cost > o.cost; }  // min-heap
};

}  // namespace

extern "C" {

// Decimate to ~target_faces.  Outputs are written into caller buffers sized
// [nv*3] / [nf*3]; returns the new face count, and *out_nv the vertex count.
int qem_decimate(const float *verts, int nv, const int *faces, int nf,
                 int target_faces, float *out_verts, int *out_faces,
                 int *out_nv) {
    std::vector<Vec3> v(nv);
    for (int i = 0; i < nv; i++)
        v[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    std::vector<std::array<int, 3>> f(nf);
    for (int i = 0; i < nf; i++)
        f[i] = {faces[3 * i], faces[3 * i + 1], faces[3 * i + 2]};

    std::vector<Quadric> Q(nv);
    for (auto &tri : f) {
        Vec3 n = (v[tri[1]] - v[tri[0]]).cross(v[tri[2]] - v[tri[0]]);
        double len = n.norm();
        if (len < 1e-20) continue;
        n = n * (1.0 / len);
        double d = -n.dot(v[tri[0]]);
        for (int k = 0; k < 3; k++) Q[tri[k]].add_plane(n.x, n.y, n.z, d);
    }

    // union-find
    std::vector<int> parent(nv);
    for (int i = 0; i < nv; i++) parent[i] = i;
    std::function<int(int)> find = [&](int a) {
        while (parent[a] != a) { parent[a] = parent[parent[a]]; a = parent[a]; }
        return a;
    };

    // vertex -> incident faces
    std::vector<std::vector<int>> vf(nv);
    for (int i = 0; i < nf; i++)
        for (int k = 0; k < 3; k++) vf[f[i][k]].push_back(i);

    std::vector<int64_t> version(nv, 0);
    std::priority_queue<HeapEntry> heap;

    auto push_edge = [&](int a, int b) {
        if (a == b) return;
        Quadric qe = Q[a] + Q[b];
        Vec3 t;
        if (!qe.minimize(t)) t = (v[a] + v[b]) * 0.5;
        heap.push({qe.eval(t), a, b, version[a], version[b], t});
    };

    {
        std::unordered_set<int64_t> seen;
        seen.reserve(nf * 3);
        for (auto &tri : f) {
            for (int k = 0; k < 3; k++) {
                int a = tri[k], b = tri[(k + 1) % 3];
                int lo = std::min(a, b), hi = std::max(a, b);
                int64_t key = (int64_t)lo * nv + hi;
                if (seen.insert(key).second) push_edge(lo, hi);
            }
        }
    }

    std::vector<char> face_alive(nf, 1);
    int alive = nf;

    while (alive > target_faces && !heap.empty()) {
        HeapEntry e = heap.top();
        heap.pop();
        int ra = find(e.a), rb = find(e.b);
        if (ra == rb) continue;
        if (version[ra] != e.va || version[rb] != e.vb) {
            if (ra != rb) push_edge(ra, rb);
            continue;
        }
        // collapse rb into ra
        parent[rb] = ra;
        v[ra] = e.target;
        Q[ra] = Q[ra] + Q[rb];
        version[ra]++;

        std::vector<int> merged;
        merged.reserve(vf[ra].size() + vf[rb].size());
        merged.insert(merged.end(), vf[ra].begin(), vf[ra].end());
        merged.insert(merged.end(), vf[rb].begin(), vf[rb].end());
        std::sort(merged.begin(), merged.end());
        merged.erase(std::unique(merged.begin(), merged.end()), merged.end());

        std::vector<int> keep;
        std::unordered_set<int> neighbors;
        for (int fi : merged) {
            if (!face_alive[fi]) continue;
            int x = find(f[fi][0]), y = find(f[fi][1]), z = find(f[fi][2]);
            if (x == y || y == z || z == x) {
                face_alive[fi] = 0;
                alive--;
            } else {
                f[fi] = {x, y, z};
                keep.push_back(fi);
                for (int t : {x, y, z})
                    if (t != ra) neighbors.insert(t);
            }
        }
        vf[ra] = std::move(keep);
        vf[rb].clear();
        for (int nb : neighbors) push_edge(ra, nb);
    }

    // compact output
    std::vector<int> remap(nv, -1);
    int nvo = 0, nfo = 0;
    for (int i = 0; i < nf; i++) {
        if (!face_alive[i]) continue;
        int tri[3];
        bool ok = true;
        for (int k = 0; k < 3; k++) {
            int r = find(f[i][k]);
            tri[k] = r;
        }
        if (tri[0] == tri[1] || tri[1] == tri[2] || tri[2] == tri[0]) ok = false;
        if (!ok) continue;
        for (int k = 0; k < 3; k++) {
            int r = tri[k];
            if (remap[r] < 0) {
                remap[r] = nvo;
                out_verts[3 * nvo] = (float)v[r].x;
                out_verts[3 * nvo + 1] = (float)v[r].y;
                out_verts[3 * nvo + 2] = (float)v[r].z;
                nvo++;
            }
            out_faces[3 * nfo + k] = remap[r];
        }
        nfo++;
    }
    *out_nv = nvo;
    return nfo;
}

// Farthest point sampling: greedy max-min over n points, k samples.
// O(n*k); out_idx gets the chosen indices.
void farthest_point_sampling(const float *pts, int n, int k, int start,
                             int *out_idx) {
    std::vector<float> dist(n, 1e30f);
    int cur = start % std::max(n, 1);
    for (int s = 0; s < k; s++) {
        out_idx[s] = cur;
        const float cx = pts[3 * cur], cy = pts[3 * cur + 1], cz = pts[3 * cur + 2];
        float best = -1.0f;
        int best_i = 0;
        for (int i = 0; i < n; i++) {
            float dx = pts[3 * i] - cx, dy = pts[3 * i + 1] - cy,
                  dz = pts[3 * i + 2] - cz;
            float d = dx * dx + dy * dy + dz * dz;
            if (d < dist[i]) dist[i] = d;
            if (dist[i] > best) { best = dist[i]; best_i = i; }
        }
        cur = best_i;
    }
}

}  // extern "C"
