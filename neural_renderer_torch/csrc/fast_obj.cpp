// Fast Wavefront OBJ parser (native side of neural_renderer_torch.io.obj;
// the port's own copy of the JAX package's csrc/fast_obj.cpp).
//
// The reference's asset loader is pure Python line splitting
// (load_obj.py:146-175) — fine for the teapot, painful for ShapeNet-scale
// meshes (the reference's own misc/render.py workload).  This parser
// tokenizes the common subset the renderer consumes — `v` lines (xyz) and
// `f` lines with polygon fan triangulation, `v/vt/vn` index forms —
// in a single pass over a memory buffer.
//
// C ABI (ctypes-friendly):
//   fobj_parse(path, &vertices, &nv, &faces, &nf) -> 0 on success
//     vertices: malloc'd float[nv*3]; faces: malloc'd int32[nf*3]
//     (0-based vertex indices, 1-based and negative OBJ indices resolved)
//   fobj_free(ptr): release a buffer returned by fobj_parse
//
// Build: g++ -O2 -shared -fPIC, by neural_renderer_torch/_build.py
// (build_host) into neural_renderer_torch/_build/ on first use; io/obj.py
// falls back to the Python parser if g++ or the build is unavailable.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// strtof-style float scan that also advances the cursor.
inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* skip_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline const char* parse_int(const char* p, const char* end, long* out,
                             bool* ok) {
    p = skip_ws(p, end);
    char* q = nullptr;
    long v = strtol(p, &q, 10);
    *ok = (q != p);
    *out = v;
    return q;
}

}  // namespace

extern "C" {

int fobj_parse(const char* path, float** vertices_out, int* nv_out,
               int** faces_out, int* nf_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        fclose(f);
        return 2;
    }
    fclose(f);
    buf[size] = '\n';

    std::vector<float> verts;
    std::vector<int> faces;
    std::vector<long> poly;
    verts.reserve(1 << 14);
    faces.reserve(1 << 14);

    const char* p = buf.data();
    const char* end = buf.data() + size;
    while (p < end) {
        p = skip_ws(p, end);
        if (p + 1 < end && p[0] == 'v' &&
            (p[1] == ' ' || p[1] == '\t')) {
            // vertex line: v x y z
            const char* q = p + 1;
            for (int k = 0; k < 3; ++k) {
                char* r = nullptr;
                float v = strtof(q, &r);
                if (r == q) { v = 0.0f; }
                verts.push_back(v);
                q = r;
            }
            p = skip_line(q, end);
        } else if (p < end && p[0] == 'f' &&
                   (p + 1 >= end || p[1] == ' ' || p[1] == '\t')) {
            // face line: f i[/..] j[/..] k[/..] [l...] — fan triangulate
            const char* q = p + 1;
            poly.clear();
            while (q < end && *q != '\n') {
                bool ok = false;
                long idx = 0;
                q = parse_int(q, end, &idx, &ok);
                if (!ok) break;
                poly.push_back(idx);
                // skip any /vt/vn part of this corner
                while (q < end && *q != ' ' && *q != '\t' && *q != '\n' &&
                       *q != '\r')
                    ++q;
            }
            long nvert = static_cast<long>(verts.size()) / 3;
            // fan triangulation: (0, i, i+1)
            for (size_t i = 1; i + 1 < poly.size(); ++i) {
                long tri[3] = {poly[0], poly[i], poly[i + 1]};
                for (int k = 0; k < 3; ++k) {
                    long v = tri[k];
                    // resolve 1-based / negative OBJ indices
                    v = v > 0 ? v - 1 : nvert + v;
                    faces.push_back(static_cast<int>(v));
                }
            }
            p = skip_line(q, end);
        } else {
            p = skip_line(p, end);
        }
    }

    *nv_out = static_cast<int>(verts.size() / 3);
    *nf_out = static_cast<int>(faces.size() / 3);
    float* vbuf = static_cast<float*>(malloc(verts.size() * sizeof(float)));
    int* fbuf = static_cast<int*>(malloc(faces.size() * sizeof(int)));
    if ((!vbuf && !verts.empty()) || (!fbuf && !faces.empty())) {
        free(vbuf);
        free(fbuf);
        return 3;
    }
    memcpy(vbuf, verts.data(), verts.size() * sizeof(float));
    memcpy(fbuf, faces.data(), faces.size() * sizeof(int));
    *vertices_out = vbuf;
    *faces_out = fbuf;
    return 0;
}

void fobj_free(void* ptr) { free(ptr); }

}  // extern "C"
