// Native runtime of another_raytracer_tpu_torch: wavefront .obj/.mtl parser
// (a copy of the JAX package's native/objparser.cpp with two repairs: a
// negative texcoord index in a face corner is read, and an index outside
// the vertex or texcoord list fails the parse instead of reading past it).
//
// The reference uses the vendored rapidobj header library for its cold-path
// mesh ingestion (reference: src/primitives/mesh.h:31-64).  This is the
// equivalent native component for the TPU framework: a from-scratch C++20
// parser that fan-triangulates polygons and emits the flat triangle arrays
// the SoA scene builder consumes (positions, per-vertex texcoords, per-face
// material ids), exposed through a C ABI consumed via ctypes
// (another_raytracer_tpu_torch/utils/native.py, which builds this file with
// the host C++ compiler at first use).  models/mesh.py keeps the pure-Python
// parser as the plain version the tests hold this one against.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Mtl {
  std::string name;
  double ka[3] = {0.0, 0.0, 0.0};
  double kd[3] = {0.8, 0.8, 0.8};
  std::string map_kd;
};

struct Mesh {
  std::vector<double> tri_pos;  // T*9
  std::vector<double> tri_uv;   // T*6
  std::vector<long long> tri_mat;
  std::vector<Mtl> materials;
  std::vector<std::string> material_strings;  // serialized for the ctypes bridge
};

// Fast float parse over a token range.
inline double parse_num(const char*& p) {
  char* end = nullptr;
  double v = std::strtod(p, &end);
  p = end;
  return v;
}

inline void skip_ws(const char*& p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
}

void parse_mtl(const std::string& path, std::vector<Mtl>& out,
               std::unordered_map<std::string, long long>& by_name) {
  std::ifstream f(path);
  if (!f) return;
  std::string line;
  Mtl* cur = nullptr;
  while (std::getline(f, line)) {
    const char* p = line.c_str();
    skip_ws(p);
    if (std::strncmp(p, "newmtl", 6) == 0 && (p[6] == ' ' || p[6] == '\t')) {
      p += 6;
      skip_ws(p);
      std::string name(p);
      while (!name.empty() && (name.back() == '\r' || name.back() == ' ')) name.pop_back();
      by_name[name] = static_cast<long long>(out.size());
      out.push_back(Mtl{name, {0, 0, 0}, {0.8, 0.8, 0.8}, ""});
      cur = &out.back();
    } else if (cur && p[0] == 'K' && p[1] == 'a' && std::isspace(p[2])) {
      p += 2;
      for (double& c : cur->ka) { skip_ws(p); c = parse_num(p); }
    } else if (cur && p[0] == 'K' && p[1] == 'd' && std::isspace(p[2])) {
      p += 2;
      for (double& c : cur->kd) { skip_ws(p); c = parse_num(p); }
    } else if (cur && std::strncmp(p, "map_Kd", 6) == 0) {
      p += 6;
      skip_ws(p);
      std::string v(p);
      while (!v.empty() && (v.back() == '\r' || v.back() == ' ')) v.pop_back();
      // keep only the last token (options like -s are not supported)
      auto sp = v.find_last_of(" \t");
      cur->map_kd = (sp == std::string::npos) ? v : v.substr(sp + 1);
    }
  }
}

Mesh* parse_obj(const char* path_cstr) {
  std::ifstream f(path_cstr);
  if (!f) return nullptr;

  std::string path(path_cstr);
  std::string dir;
  {
    auto sp = path.find_last_of("/\\");
    dir = (sp == std::string::npos) ? std::string(".") : path.substr(0, sp);
  }

  auto mesh = new Mesh();
  std::vector<double> positions;  // 3*n
  std::vector<double> texcoords;  // 2*n
  std::unordered_map<std::string, long long> mat_by_name;
  long long cur_mat = -1;

  std::string line;
  std::vector<std::pair<long long, long long>> corners;  // (vi, ti) per face
  while (std::getline(f, line)) {
    const char* p = line.c_str();
    skip_ws(p);
    if (p[0] == 'v' && std::isspace(p[1])) {
      ++p;
      for (int k = 0; k < 3; ++k) { skip_ws(p); positions.push_back(parse_num(p)); }
    } else if (p[0] == 'v' && p[1] == 't' && std::isspace(p[2])) {
      p += 2;
      skip_ws(p);
      texcoords.push_back(parse_num(p));
      skip_ws(p);
      texcoords.push_back((*p && *p != '\r') ? parse_num(p) : 0.0);
    } else if (p[0] == 'f' && std::isspace(p[1])) {
      ++p;
      corners.clear();
      while (true) {
        skip_ws(p);
        if (!*p || *p == '\r' || *p == '#') break;
        // A corner that is not an index ("x", "1.0") fails the parse, as
        // the Python parser's int() raises on it.
        const char* start = p;
        long long vi = std::strtoll(p, const_cast<char**>(&p), 10);
        if (p == start) { delete mesh; return nullptr; }
        long long ti = 0;
        if (*p == '/') {
          ++p;
          // A texcoord index may be negative (relative to the end of the
          // list); "1//3" and "1/" have none.
          if (*p && *p != '/' && !std::isspace(static_cast<unsigned char>(*p))) {
            start = p;
            ti = std::strtoll(p, const_cast<char**>(&p), 10);
            if (p == start) { delete mesh; return nullptr; }
          }
          if (*p == '/') {  // the normal index is not read
            while (*p && !std::isspace(static_cast<unsigned char>(*p))) ++p;
          }
        }
        if (*p && !std::isspace(static_cast<unsigned char>(*p))) {
          delete mesh;
          return nullptr;
        }
        corners.emplace_back(vi, ti);
      }
      const long long nv = static_cast<long long>(positions.size()) / 3;
      const long long nt = static_cast<long long>(texcoords.size()) / 2;
      auto rv = [&](long long i) { return i > 0 ? i - 1 : nv + i; };
      auto rt = [&](long long i) { return i > 0 ? i - 1 : nt + i; };
      for (const auto& [vi, ti] : corners) {
        const long long v = rv(vi), t = rt(ti);
        if (vi == 0 || v < 0 || v >= nv ||
            (ti != 0 && nt > 0 && (t < 0 || t >= nt))) {
          delete mesh;
          return nullptr;
        }
      }
      // fan triangulation (0, i, i+1), as rapidobj::Triangulate does
      for (size_t i = 1; i + 1 < corners.size(); ++i) {
        const std::pair<long long, long long> tri[3] = {
            corners[0], corners[i], corners[i + 1]};
        for (const auto& [vi, ti] : tri) {
          const long long v = rv(vi);
          mesh->tri_pos.push_back(positions[3 * v + 0]);
          mesh->tri_pos.push_back(positions[3 * v + 1]);
          mesh->tri_pos.push_back(positions[3 * v + 2]);
          if (ti != 0 && nt > 0) {
            const long long t = rt(ti);
            mesh->tri_uv.push_back(texcoords[2 * t + 0]);
            mesh->tri_uv.push_back(texcoords[2 * t + 1]);
          } else {
            mesh->tri_uv.push_back(0.0);
            mesh->tri_uv.push_back(0.0);
          }
        }
        mesh->tri_mat.push_back(cur_mat);
      }
    } else if (std::strncmp(p, "mtllib", 6) == 0) {
      p += 6;
      skip_ws(p);
      std::string rel(p);
      while (!rel.empty() && (rel.back() == '\r' || rel.back() == ' ')) rel.pop_back();
      parse_mtl(dir + "/" + rel, mesh->materials, mat_by_name);
    } else if (std::strncmp(p, "usemtl", 6) == 0) {
      p += 6;
      skip_ws(p);
      std::string name(p);
      while (!name.empty() && (name.back() == '\r' || name.back() == ' ')) name.pop_back();
      auto it = mat_by_name.find(name);
      cur_mat = (it == mat_by_name.end()) ? -1 : it->second;
    }
  }

  // Serialize materials for the ctypes bridge: name|ka|kd|map_kd
  char buf[64];
  for (const auto& m : mesh->materials) {
    std::string s = m.name + "|";
    for (int k = 0; k < 3; ++k) {
      std::snprintf(buf, sizeof buf, "%.17g%s", m.ka[k], k < 2 ? "," : "");
      s += buf;
    }
    s += "|";
    for (int k = 0; k < 3; ++k) {
      std::snprintf(buf, sizeof buf, "%.17g%s", m.kd[k], k < 2 ? "," : "");
      s += buf;
    }
    s += "|" + m.map_kd;
    mesh->material_strings.push_back(std::move(s));
  }
  return mesh;
}

}  // namespace

extern "C" {

void* artpu_parse_obj(const char* path) { return parse_obj(path); }

long long artpu_mesh_num_triangles(void* h) {
  return static_cast<long long>(static_cast<Mesh*>(h)->tri_mat.size());
}

long long artpu_mesh_num_materials(void* h) {
  return static_cast<long long>(static_cast<Mesh*>(h)->materials.size());
}

void artpu_mesh_fill(void* h, double* tri_pos, double* tri_uv, long long* tri_mat) {
  auto* m = static_cast<Mesh*>(h);
  std::memcpy(tri_pos, m->tri_pos.data(), m->tri_pos.size() * sizeof(double));
  std::memcpy(tri_uv, m->tri_uv.data(), m->tri_uv.size() * sizeof(double));
  std::memcpy(tri_mat, m->tri_mat.data(), m->tri_mat.size() * sizeof(long long));
}

const char* artpu_mesh_material(void* h, long long i) {
  return static_cast<Mesh*>(h)->material_strings[static_cast<size_t>(i)].c_str();
}

void artpu_mesh_free(void* h) { delete static_cast<Mesh*>(h); }

}  // extern "C"
