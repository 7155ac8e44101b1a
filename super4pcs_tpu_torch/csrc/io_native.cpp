// Native IO parsers of super4pcs_tpu_torch (the PyTorch port): the
// port's own copy of the JAX package's native/io_native.cpp, built with
// g++ at first use by super4pcs_tpu_torch/io/native.py.
//
// The reference implements its IO tier in C++ (src/super4pcs/io/ —
// per-line sscanf loops); this is its native equivalent: a
// zero-dependency, single-pass OBJ + PLY reader exported through a C
// ABI and loaded from Python via ctypes.
//
// Contract: every parse_* call returns 0 on success and fills out-params
// with malloc'd buffers the caller must release via s4p_free(). Counts
// are element counts (not bytes). On failure returns a negative code and
// leaves outputs null.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buf {
  char* data = nullptr;
  size_t size = 0;
  ~Buf() { free(data); }
};

int read_file(const char* path, Buf& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) { fclose(f); return -1; }
  out.data = static_cast<char*>(malloc(static_cast<size_t>(n) + 1));
  if (!out.data) { fclose(f); return -2; }
  size_t got = fread(out.data, 1, static_cast<size_t>(n), f);
  fclose(f);
  out.data[got] = '\0';
  out.size = got;
  return 0;
}

// fast float parse (strtof wrapper advancing the cursor)
inline float parse_f(const char*& p) {
  char* end;
  float v = strtof(p, &end);
  p = end;
  return v;
}

inline long parse_i(const char*& p) {
  char* end;
  long v = strtol(p, &end, 10);
  p = end;
  return v;
}

inline void skip_ws(const char*& p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
}

inline void skip_line(const char*& p) {
  while (*p && *p != '\n') ++p;
  if (*p == '\n') ++p;
}

template <typename T>
T* steal(std::vector<T>& v, int64_t* count) {
  *count = static_cast<int64_t>(v.size());
  if (v.empty()) return nullptr;
  T* out = static_cast<T*>(malloc(v.size() * sizeof(T)));
  if (out) memcpy(out, v.data(), v.size() * sizeof(T));
  return out;
}

}  // namespace

extern "C" {

void s4p_free(void* p) { free(p); }

// ---------------------------------------------------------------------
// OBJ
// ---------------------------------------------------------------------
// Semantics mirror the reference reader (io.cc:140-267): v/vn/vt/f with
// a, a/t, a//n, a/t/n face forms (1-based; negatives resolved relative
// to the current vertex count); mtllib names collected.
int parse_obj(const char* path,
              float** v_out, int64_t* nv,
              float** vn_out, int64_t* nvn,
              float** vt_out, int64_t* nvt,
              int32_t** f_out, int64_t* nf,   // (nf, 9): v0 t0 n0 v1 ...
              char** mtl_out, int64_t* mtl_len) {
  *v_out = *vn_out = *vt_out = nullptr;
  *f_out = nullptr;
  *mtl_out = nullptr;
  *nv = *nvn = *nvt = *nf = *mtl_len = 0;

  Buf buf;
  if (int rc = read_file(path, buf)) return rc;

  std::vector<float> v, vn, vt;
  std::vector<int32_t> faces;
  std::string mtls;
  v.reserve(1 << 16);

  const char* p = buf.data;
  while (*p) {
    skip_ws(p);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      v.push_back(parse_f(p));
      v.push_back(parse_f(p));
      v.push_back(parse_f(p));
    } else if (p[0] == 'v' && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      p += 3;
      vn.push_back(parse_f(p));
      vn.push_back(parse_f(p));
      vn.push_back(parse_f(p));
    } else if (p[0] == 'v' && p[1] == 't' &&
               (p[2] == ' ' || p[2] == '\t')) {
      p += 3;
      vt.push_back(parse_f(p));
      vt.push_back(parse_f(p));
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      // parse up to 3 corners: idx[/[t]][/n]
      for (int c = 0; c < 3; ++c) {
        skip_ws(p);
        long a = parse_i(p), t = 0, n = 0;
        if (*p == '/') {
          ++p;
          if (*p != '/') t = parse_i(p);
          if (*p == '/') {
            ++p;
            n = parse_i(p);
          }
        }
        long nvtx = static_cast<long>(v.size() / 3);
        if (a < 0) a = nvtx + a + 1;  // negative = relative
        if (t < 0) t = static_cast<long>(vt.size() / 2) + t + 1;
        if (n < 0) n = static_cast<long>(vn.size() / 3) + n + 1;
        faces.push_back(static_cast<int32_t>(a));
        faces.push_back(static_cast<int32_t>(t));
        faces.push_back(static_cast<int32_t>(n));
      }
    } else if (!strncmp(p, "mtllib", 6)) {
      p += 6;
      skip_ws(p);
      const char* s = p;
      while (*p && *p != '\n' && *p != '\r') ++p;
      if (!mtls.empty()) mtls.push_back('\n');
      mtls.append(s, static_cast<size_t>(p - s));
    }
    skip_line(p);
  }

  if (v.empty()) return -3;

  int64_t dummy;
  *v_out = steal(v, &dummy);
  *nv = dummy / 3;
  *vn_out = steal(vn, &dummy);
  *nvn = dummy / 3;
  *vt_out = steal(vt, &dummy);
  *nvt = dummy / 2;
  *f_out = steal(faces, &dummy);
  *nf = dummy / 9;
  if (!mtls.empty()) {
    *mtl_out = static_cast<char*>(malloc(mtls.size() + 1));
    memcpy(*mtl_out, mtls.c_str(), mtls.size() + 1);
    *mtl_len = static_cast<int64_t>(mtls.size());
  }
  return 0;
}

// ---------------------------------------------------------------------
// PLY
// ---------------------------------------------------------------------
// Property subset per the reference contract (doc/File-formats.md):
// float/double x y z [nx ny nz] [uchar r g b [a]]; ascii and binary in
// both endiannesses. Unknown vertex properties are skipped; non-vertex
// elements after the vertex block are ignored.

namespace {

struct PlyProp {
  int kind;   // 0 x.. 2 z, 3 nx.. 5 nz, 6 r.. 9 a, -1 skip
  int size;   // bytes (binary)
  bool is_float;
  bool is_double;
};

inline float load_scalar(const char* q, const PlyProp& pr, bool swap) {
  unsigned char tmp[8];
  memcpy(tmp, q, static_cast<size_t>(pr.size));
  if (swap) {
    for (int i = 0; i < pr.size / 2; ++i) {
      unsigned char t = tmp[i];
      tmp[i] = tmp[pr.size - 1 - i];
      tmp[pr.size - 1 - i] = t;
    }
  }
  if (pr.is_double) {
    double d;
    memcpy(&d, tmp, 8);
    return static_cast<float>(d);
  }
  if (pr.is_float) {
    float f;
    memcpy(&f, tmp, 4);
    return f;
  }
  // integer types, unsigned interpretation is fine for uchar colors
  switch (pr.size) {
    case 1: return static_cast<float>(*reinterpret_cast<uint8_t*>(tmp));
    case 2: return static_cast<float>(*reinterpret_cast<uint16_t*>(tmp));
    default: return static_cast<float>(*reinterpret_cast<uint32_t*>(tmp));
  }
}

}  // namespace

int parse_ply(const char* path,
              float** pos_out, float** nrm_out, float** rgb_out,
              int64_t* n_out) {
  *pos_out = *nrm_out = *rgb_out = nullptr;
  *n_out = 0;

  Buf buf;
  if (int rc = read_file(path, buf)) return rc;
  const char* p = buf.data;
  if (strncmp(p, "ply", 3)) return -3;
  skip_line(p);

  int fmt = -1;  // 0 ascii, 1 LE, 2 BE
  long n_vertices = 0;
  std::vector<PlyProp> props;
  bool in_vertex = false;

  while (*p) {
    if (!strncmp(p, "end_header", 10)) {
      skip_line(p);
      break;
    }
    if (!strncmp(p, "format ", 7)) {
      const char* q = p + 7;
      if (!strncmp(q, "ascii", 5)) fmt = 0;
      else if (!strncmp(q, "binary_little_endian", 20)) fmt = 1;
      else if (!strncmp(q, "binary_big_endian", 17)) fmt = 2;
    } else if (!strncmp(p, "element ", 8)) {
      const char* q = p + 8;
      in_vertex = !strncmp(q, "vertex", 6);
      if (in_vertex) {
        q += 6;
        n_vertices = parse_i(q);
      } else if (n_vertices == 0) {
        // a non-empty element declared BEFORE the vertex element would
        // have its body misread as vertex data; bail (negative code)
        // so the caller falls back to the full python parser
        while (*q && *q != ' ' && *q != '\n') ++q;
        if (parse_i(q) > 0) return -6;
      }
    } else if (!strncmp(p, "property ", 9) && in_vertex) {
      const char* q = p + 9;
      PlyProp pr{-1, 4, false, false};
      if (!strncmp(q, "list", 4)) return -4;  // list in vertex: unsupported
      if (!strncmp(q, "float64", 7) || !strncmp(q, "double", 6)) {
        pr.size = 8;
        pr.is_double = true;
      } else if (!strncmp(q, "float", 5)) {
        pr.size = 4;
        pr.is_float = true;
      } else if (!strncmp(q, "uchar", 5) || !strncmp(q, "uint8", 5) ||
                 !strncmp(q, "char", 4) || !strncmp(q, "int8", 4)) {
        pr.size = 1;
      } else if (!strncmp(q, "ushort", 6) || !strncmp(q, "short", 5) ||
                 !strncmp(q, "uint16", 6) || !strncmp(q, "int16", 5)) {
        pr.size = 2;
      } else {
        pr.size = 4;
      }
      // property name = last token on the line
      const char* e = q;
      while (*e && *e != '\n') ++e;
      const char* name = e;
      while (name > q && name[-1] != ' ') --name;
      static const char* names[] = {"x", "y", "z", "nx", "ny", "nz",
                                    "red", "green", "blue", "alpha"};
      for (int k = 0; k < 10; ++k) {
        size_t len = strlen(names[k]);
        if (!strncmp(name, names[k], len) &&
            (name[len] == '\n' || name[len] == '\r' ||
             name[len] == '\0')) {
          pr.kind = k;
          break;
        }
      }
      props.push_back(pr);
    }
    skip_line(p);
  }
  if (fmt < 0 || n_vertices <= 0) return -5;

  bool has_n = false, has_c = false;
  long stride = 0;
  for (const PlyProp& pr : props) {
    stride += pr.size;
    if (pr.kind >= 3 && pr.kind <= 5) has_n = true;
    if (pr.kind >= 6 && pr.kind <= 8) has_c = true;
  }

  float* pos = static_cast<float*>(malloc(n_vertices * 3 * sizeof(float)));
  float* nrm = has_n ? static_cast<float*>(
                           malloc(n_vertices * 3 * sizeof(float)))
                     : nullptr;
  float* rgb = has_c ? static_cast<float*>(
                           malloc(n_vertices * 3 * sizeof(float)))
                     : nullptr;

  if (fmt == 0) {
    for (long i = 0; i < n_vertices; ++i) {
      skip_ws(p);
      if (!*p) {  // body shorter than the header's vertex count
        free(pos); free(nrm); free(rgb);
        return -6;
      }
      for (const PlyProp& pr : props) {
        skip_ws(p);
        float val = parse_f(p);
        if (pr.kind >= 0 && pr.kind < 3) pos[i * 3 + pr.kind] = val;
        else if (pr.kind < 6 && pr.kind >= 3 && nrm)
          nrm[i * 3 + pr.kind - 3] = val;
        else if (pr.kind >= 6 && pr.kind < 9 && rgb)
          rgb[i * 3 + pr.kind - 6] = val;
      }
      skip_line(p);
    }
  } else {
    bool swap;
    {
      uint16_t probe = 1;
      bool host_le = *reinterpret_cast<uint8_t*>(&probe) == 1;
      swap = (fmt == 1) != host_le;
    }
    const char* q = p;
    const char* end = buf.data + buf.size;
    if (q + stride * n_vertices > end) {
      free(pos); free(nrm); free(rgb);
      return -6;
    }
    for (long i = 0; i < n_vertices; ++i) {
      for (const PlyProp& pr : props) {
        if (pr.kind >= 0) {
          float val = load_scalar(q, pr, swap);
          if (pr.kind < 3) pos[i * 3 + pr.kind] = val;
          else if (pr.kind < 6 && nrm) nrm[i * 3 + pr.kind - 3] = val;
          else if (pr.kind < 9 && rgb) rgb[i * 3 + pr.kind - 6] = val;
        }
        q += pr.size;
      }
    }
  }

  *pos_out = pos;
  *nrm_out = nrm;
  *rgb_out = rgb;
  *n_out = n_vertices;
  return 0;
}

}  // extern "C"
