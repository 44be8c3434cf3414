// Host graph kernels of the PyTorch port: a C++/OpenMP CPython extension.
//
// The port's copy of stargcn_tpu/native/graph_kernels.cpp: the same 20
// functions (method table at the end), with the same names, argument orders,
// return dtypes and error messages.  graph/native.py builds it at first use
// with g++ and loads it; graph/kernels.py wraps it.  It feeds the host
// planner (sample_block_ell, the fused block planner of BlockSampler's
// "native" route), bit packing (ops/bitdense.py:pack_bits) and the host
// graph library.
//
// One departure from the JAX package's extension: the draws.  There each OS
// thread takes an mt19937 engine by first use, so a plan drawn inside an
// OpenMP team depends on which thread reached the counter first.  Here each
// random call takes the next call number since set_seed, and each row it
// draws for (each frontier row, each target row; the whole call for the
// sequential walks) seeds a generator of its own from (seed, call number,
// row position).  A result is then a function of the seed and of how many
// random calls came before it, whatever thread or team size draws it.
//
// Built with: g++ -O3 -std=c++17 -shared -fPIC -fopenmp (graph/native.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ------------------------------- draws -------------------------------

std::atomic<uint64_t> g_seed{0};
// Random calls since the last set_seed.  Taken with the GIL held, on entry,
// so calls are numbered in the order Python makes them.
std::atomic<uint64_t> g_calls{0};

// SplitMix64's finaliser.
inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

constexpr uint64_t kGolden = 0x9e3779b97f4a7c15ULL;

// The (seed, call number) of one random call.
struct CallKey {
  uint64_t seed, call;
};

CallKey next_call() {
  return CallKey{g_seed.load(), g_calls.fetch_add(1)};
}

// A SplitMix64 generator keyed by (seed, call number, row position).
struct RowStream {
  uint64_t state;

  RowStream(const CallKey& key, uint64_t row)
      : state(mix64(mix64(mix64(key.seed + kGolden) ^ (key.call + kGolden))
                    ^ (row + kGolden))) {}

  uint64_t next() {
    state += kGolden;
    return mix64(state);
  }

  // Uniform in [0, n), n >= 1, without bias (Lemire's multiply and reject).
  uint32_t below(uint32_t n) {
    uint64_t m = static_cast<uint64_t>(static_cast<uint32_t>(next() >> 32)) * n;
    uint32_t low = static_cast<uint32_t>(m);
    if (low < n) {
      const uint32_t floor = (0u - n) % n;
      while (low < floor) {
        m = static_cast<uint64_t>(static_cast<uint32_t>(next() >> 32)) * n;
        low = static_cast<uint32_t>(m);
      }
    }
    return static_cast<uint32_t>(m >> 32);
  }

  // Uniform integer in [lo, hi], lo <= hi.
  int32_t uniform(int32_t lo, int32_t hi) {
    return lo + static_cast<int32_t>(
        below(static_cast<uint32_t>(static_cast<int64_t>(hi) - lo + 1)));
  }

  // Uniform in [0, 1) with 53 bits.
  double unit() { return static_cast<double>(next() >> 11) * 0x1.0p-53; }
};

int num_threads_capped() {
#ifdef _OPENMP
  int n = omp_get_max_threads();
  return n > 16 ? 16 : n;
#else
  return 1;
#endif
}

// Loops shorter than this run on the calling thread alone: a team's start
// and barrier cost more than they save there, and far more on a loaded
// host, where a barrier waits for every thread of the team to be scheduled.
// No result depends on the team (each row draws from its own stream, byte
// ORs and per-segment sums do not depend on the order of rows).
constexpr npy_intp kParallelMin = 2048;

int team_for(npy_intp n) {
  return n >= kParallelMin ? num_threads_capped() : 1;
}

// Caps the OpenMP team size for kernels called from the CALLING thread
// (nthreads-var is a per-thread ICV): the sampled trainer's prefetch
// producer uses this so that its planner teams leave cores to the thread
// that launches the card's work.  Returns the resulting max team size.
PyObject* py_set_omp_threads(PyObject*, PyObject* args) {
  int n = 0;
  if (!PyArg_ParseTuple(args, "i", &n)) return nullptr;
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
  return PyLong_FromLong(omp_get_max_threads());
#else
  (void)n;
  return PyLong_FromLong(1);
#endif
}

// Releases the GIL for the pure-C++ compute section of each kernel (no
// Python or NumPy API calls inside): a host kernel call (some take 100+ ms
// at ML-10M size) must not block every other Python thread, such as the
// prefetch producer, the hang monitor or a logging thread.  Concurrent
// entry is then possible; the draws share no state but the two counters
// above, read on entry with the GIL held.
struct GilScopedRelease {
  PyThreadState* st;
  GilScopedRelease() : st(PyEval_SaveThread()) {}
  ~GilScopedRelease() { PyEval_RestoreThread(st); }
};

// --- small helpers to pull typed contiguous arrays out of args ---

struct I32View {
  PyArrayObject* arr;
  const int32_t* data;
  npy_intp size;
};

bool as_i32(PyObject* obj, I32View* out) {
  PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(obj, NPY_INT32, NPY_ARRAY_IN_ARRAY));
  if (!arr) return false;
  out->arr = arr;
  out->data = static_cast<const int32_t*>(PyArray_DATA(arr));
  out->size = PyArray_SIZE(arr);
  return true;
}

struct F32View {
  PyArrayObject* arr;
  const float* data;
  npy_intp size;
};

bool as_f32(PyObject* obj, F32View* out) {
  PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(obj, NPY_FLOAT32, NPY_ARRAY_IN_ARRAY));
  if (!arr) return false;
  out->arr = arr;
  out->data = static_cast<const float*>(PyArray_DATA(arr));
  out->size = PyArray_SIZE(arr);
  return true;
}

PyObject* make_i32(const std::vector<int32_t>& v) {
  npy_intp dims[1] = {static_cast<npy_intp>(v.size())};
  PyObject* arr = PyArray_SimpleNew(1, dims, NPY_INT32);
  if (arr) {
    std::copy(v.begin(), v.end(), static_cast<int32_t*>(PyArray_DATA(
        reinterpret_cast<PyArrayObject*>(arr))));
  }
  return arr;
}

PyObject* make_i64(const std::vector<int64_t>& v) {
  npy_intp dims[1] = {static_cast<npy_intp>(v.size())};
  PyObject* arr = PyArray_SimpleNew(1, dims, NPY_INT64);
  if (arr) {
    std::copy(v.begin(), v.end(), static_cast<int64_t*>(PyArray_DATA(
        reinterpret_cast<PyArrayObject*>(arr))));
  }
  return arr;
}

PyObject* make_f32(const std::vector<float>& v) {
  npy_intp dims[1] = {static_cast<npy_intp>(v.size())};
  PyObject* arr = PyArray_SimpleNew(1, dims, NPY_FLOAT32);
  if (arr) {
    std::copy(v.begin(), v.end(), static_cast<float*>(PyArray_DATA(
        reinterpret_cast<PyArrayObject*>(arr))));
  }
  return arr;
}

// Whether every row index of ``rows`` names a row of the CSR ``ptr``; sets
// IndexError naming ``fn`` where one does not (the random kernels index
// ``ptr`` with them unchecked).
bool rows_in_range(const I32View& rows, const I32View& ptr, const char* fn) {
  const npy_intp n = ptr.size - 1;
  for (npy_intp i = 0; i < rows.size; ++i) {
    if (rows.data[i] < 0 || rows.data[i] >= n) {
      PyErr_Format(PyExc_IndexError, "%s: row %d out of range [0, %zd)", fn,
                   rows.data[i], static_cast<Py_ssize_t>(n));
      return false;
    }
  }
  return true;
}

// Build a tuple that STEALS the element references (PyTuple_Pack would
// increment them, leaking every freshly created array — each call site
// here passes new references).  Null elements (allocation failure)
// propagate as an error with everything released.
PyObject* pack_steal(std::initializer_list<PyObject*> items) {
  bool ok = true;
  for (PyObject* it : items) ok = ok && (it != nullptr);
  PyObject* tup = ok ? PyTuple_New(static_cast<Py_ssize_t>(items.size()))
                     : nullptr;
  if (!tup) {
    for (PyObject* it : items) Py_XDECREF(it);
    if (ok) return nullptr;            // PyTuple_New already set the error
    if (!PyErr_Occurred()) PyErr_NoMemory();
    return nullptr;
  }
  Py_ssize_t i = 0;
  for (PyObject* it : items) PyTuple_SET_ITEM(tup, i++, it);
  return tup;
}

// ------------------------- exported functions -------------------------

PyObject* py_set_seed(PyObject*, PyObject* args) {
  unsigned long long seed;
  if (!PyArg_ParseTuple(args, "K", &seed)) return nullptr;
  g_seed.store(static_cast<uint64_t>(seed));
  g_calls.store(0);
  Py_RETURN_NONE;
}

// Order-of-first-occurrence unique + inverse indices.
PyObject* py_unique_inverse(PyObject*, PyObject* args) {
  PyObject* in;
  if (!PyArg_ParseTuple(args, "O", &in)) return nullptr;
  I32View a;
  if (!as_i32(in, &a)) return nullptr;
  std::vector<int32_t> uniq;
  std::vector<int32_t> inverse(a.size);
  {
    GilScopedRelease nogil;
    std::unordered_map<int32_t, int32_t> seen;
    seen.reserve(static_cast<size_t>(a.size) * 2 + 16);
    for (npy_intp i = 0; i < a.size; ++i) {
      auto it = seen.find(a.data[i]);
      if (it == seen.end()) {
        int32_t idx = static_cast<int32_t>(uniq.size());
        seen.emplace(a.data[i], idx);
        uniq.push_back(a.data[i]);
        inverse[i] = idx;
      } else {
        inverse[i] = it->second;
      }
    }
  }
  Py_DECREF(a.arr);
  return pack_steal({make_i32(uniq), make_i32(inverse)});
}

PyObject* py_unique_cnt(PyObject*, PyObject* args) {
  PyObject* in;
  if (!PyArg_ParseTuple(args, "O", &in)) return nullptr;
  I32View a;
  if (!as_i32(in, &a)) return nullptr;
  std::vector<int32_t> uniq;
  std::vector<int32_t> cnt;
  {
    GilScopedRelease nogil;
    std::unordered_map<int32_t, int32_t> seen;
    seen.reserve(static_cast<size_t>(a.size) * 2 + 16);
    for (npy_intp i = 0; i < a.size; ++i) {
      auto it = seen.find(a.data[i]);
      if (it == seen.end()) {
        seen.emplace(a.data[i], static_cast<int32_t>(uniq.size()));
        uniq.push_back(a.data[i]);
        cnt.push_back(1);
      } else {
        ++cnt[it->second];
      }
    }
  }
  Py_DECREF(a.arr);
  return pack_steal({make_i32(uniq), make_i32(cnt)});
}

// Parallel 1-D gather.
PyObject* py_take_1d(PyObject*, PyObject* args) {
  PyObject *data_obj, *idx_obj;
  if (!PyArg_ParseTuple(args, "OO", &data_obj, &idx_obj)) return nullptr;
  I32View idx;
  if (!as_i32(idx_obj, &idx)) return nullptr;
  PyArrayObject* data = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OF(data_obj, NPY_ARRAY_IN_ARRAY));
  if (!data) { Py_DECREF(idx.arr); return nullptr; }
  int type = PyArray_TYPE(data);
  if (type != NPY_INT32 && type != NPY_FLOAT32) {
    Py_DECREF(idx.arr); Py_DECREF(data);
    PyErr_SetString(PyExc_TypeError, "take_1d: data must be int32/float32");
    return nullptr;
  }
  npy_intp dims[1] = {idx.size};
  PyObject* out_obj = PyArray_SimpleNew(1, dims, type);
  if (!out_obj) { Py_DECREF(idx.arr); Py_DECREF(data); return nullptr; }
  if (type == NPY_INT32) {
    const int32_t* d = static_cast<const int32_t*>(PyArray_DATA(data));
    int32_t* o = static_cast<int32_t*>(PyArray_DATA(
        reinterpret_cast<PyArrayObject*>(out_obj)));
    GilScopedRelease nogil;
#pragma omp parallel for num_threads(team_for(idx.size))
    for (npy_intp i = 0; i < idx.size; ++i) o[i] = d[idx.data[i]];
  } else {
    const float* d = static_cast<const float*>(PyArray_DATA(data));
    float* o = static_cast<float*>(PyArray_DATA(
        reinterpret_cast<PyArrayObject*>(out_obj)));
    GilScopedRelease nogil;
#pragma omp parallel for num_threads(team_for(idx.size))
    for (npy_intp i = 0; i < idx.size; ++i) o[i] = d[idx.data[i]];
  }
  Py_DECREF(idx.arr);
  Py_DECREF(data);
  return out_obj;
}

// CSR -> COO row expansion.
PyObject* py_gen_row_indices(PyObject*, PyObject* args) {
  PyObject* indptr_obj;
  long long nnz;
  if (!PyArg_ParseTuple(args, "OL", &indptr_obj, &nnz)) return nullptr;
  I32View p;
  if (!as_i32(indptr_obj, &p)) return nullptr;
  npy_intp dims[1] = {static_cast<npy_intp>(nnz)};
  PyObject* out_obj = PyArray_SimpleNew(1, dims, NPY_INT32);
  if (!out_obj) { Py_DECREF(p.arr); return nullptr; }
  int32_t* o = static_cast<int32_t*>(PyArray_DATA(
      reinterpret_cast<PyArrayObject*>(out_obj)));
  npy_intp rows = p.size - 1;
  {
    GilScopedRelease nogil;
#pragma omp parallel for num_threads(team_for(rows))
    for (npy_intp i = 0; i < rows; ++i) {
      for (int32_t j = p.data[i]; j < p.data[i + 1]; ++j) o[j] = (int32_t)i;
    }
  }
  Py_DECREF(p.arr);
  return out_obj;
}

// Segment arithmetic over CSR segments.
PyObject* py_seg_sum(PyObject*, PyObject* args) {
  PyObject *d_obj, *p_obj;
  if (!PyArg_ParseTuple(args, "OO", &d_obj, &p_obj)) return nullptr;
  F32View d; I32View p;
  if (!as_f32(d_obj, &d)) return nullptr;
  if (!as_i32(p_obj, &p)) { Py_DECREF(d.arr); return nullptr; }
  npy_intp segs = p.size - 1;
  std::vector<float> out(segs, 0.f);
  {
    GilScopedRelease nogil;
#pragma omp parallel for num_threads(team_for(segs))
    for (npy_intp i = 0; i < segs; ++i) {
      float acc = 0.f;
      for (int32_t j = p.data[i]; j < p.data[i + 1]; ++j) acc += d.data[j];
      out[i] = acc;
    }
  }
  Py_DECREF(d.arr); Py_DECREF(p.arr);
  return make_f32(out);
}

enum class SegBinOp { kAdd, kMul };

PyObject* seg_binary(PyObject* args, SegBinOp op) {
  PyObject *l_obj, *r_obj, *p_obj;
  if (!PyArg_ParseTuple(args, "OOO", &l_obj, &r_obj, &p_obj)) return nullptr;
  F32View l, r; I32View p;
  if (!as_f32(l_obj, &l)) return nullptr;
  if (!as_f32(r_obj, &r)) { Py_DECREF(l.arr); return nullptr; }
  if (!as_i32(p_obj, &p)) { Py_DECREF(l.arr); Py_DECREF(r.arr); return nullptr; }
  std::vector<float> out(l.size);
  npy_intp segs = p.size - 1;
  {
    GilScopedRelease nogil;
#pragma omp parallel for num_threads(team_for(segs))
    for (npy_intp i = 0; i < segs; ++i) {
      float v = r.data[i];
      for (int32_t j = p.data[i]; j < p.data[i + 1]; ++j) {
        out[j] = (op == SegBinOp::kAdd) ? l.data[j] + v : l.data[j] * v;
      }
    }
  }
  Py_DECREF(l.arr); Py_DECREF(r.arr); Py_DECREF(p.arr);
  return make_f32(out);
}

PyObject* py_seg_add(PyObject*, PyObject* args) {
  return seg_binary(args, SegBinOp::kAdd);
}
PyObject* py_seg_mul(PyObject*, PyObject* args) {
  return seg_binary(args, SegBinOp::kMul);
}

// Per-edge GCN support: 1/sqrt(d_row*d_col) (symm) or 1/d_row, in float32.
PyObject* py_get_support(PyObject*, PyObject* args) {
  PyObject *rd_obj, *cd_obj, *p_obj, *ep_obj;
  int symm;
  if (!PyArg_ParseTuple(args, "OOOOi", &rd_obj, &cd_obj, &p_obj, &ep_obj,
                        &symm)) return nullptr;
  I32View rd, cd, p, ep;
  if (!as_i32(rd_obj, &rd)) return nullptr;
  if (!as_i32(cd_obj, &cd)) { Py_DECREF(rd.arr); return nullptr; }
  if (!as_i32(p_obj, &p)) { Py_DECREF(rd.arr); Py_DECREF(cd.arr); return nullptr; }
  if (!as_i32(ep_obj, &ep)) {
    Py_DECREF(rd.arr); Py_DECREF(cd.arr); Py_DECREF(p.arr); return nullptr;
  }
  std::vector<float> out(ep.size, 0.f);
  npy_intp rows = p.size - 1;
  {
    GilScopedRelease nogil;
#pragma omp parallel for num_threads(team_for(rows))
    for (npy_intp i = 0; i < rows; ++i) {
      int32_t r_deg = rd.data[i];
      for (int32_t j = p.data[i]; j < p.data[i + 1]; ++j) {
        if (symm) {
          int32_t c_deg = cd.data[ep.data[j]];
          if (r_deg != 0 && c_deg != 0) {
            out[j] = std::sqrt(1.0f / static_cast<float>(r_deg) /
                               static_cast<float>(c_deg));
          }
        } else if (r_deg != 0) {
          out[j] = 1.0f / static_cast<float>(r_deg);
        }
      }
    }
  }
  Py_DECREF(rd.arr); Py_DECREF(cd.arr); Py_DECREF(p.arr); Py_DECREF(ep.arr);
  return make_f32(out);
}

// Row/col submatrix with column remapping.
// Returns (new_indptr i32, new_endpoints i32, edge_idx i64).
PyObject* py_csr_submat(PyObject*, PyObject* args) {
  PyObject *p_obj, *ep_obj, *ri_obj, *ci_obj;
  long long num_cols;
  if (!PyArg_ParseTuple(args, "OOOOL", &p_obj, &ep_obj, &ri_obj, &ci_obj,
                        &num_cols)) return nullptr;
  I32View p, ep, ri, ci;
  if (!as_i32(p_obj, &p)) return nullptr;
  if (!as_i32(ep_obj, &ep)) { Py_DECREF(p.arr); return nullptr; }
  if (!as_i32(ri_obj, &ri)) { Py_DECREF(p.arr); Py_DECREF(ep.arr); return nullptr; }
  if (!as_i32(ci_obj, &ci)) {
    Py_DECREF(p.arr); Py_DECREF(ep.arr); Py_DECREF(ri.arr); return nullptr;
  }
  std::vector<int32_t> new_ptr(ri.size + 1, 0);
  std::vector<int32_t> new_ep;
  std::vector<int64_t> edge_idx;
  {
    GilScopedRelease nogil;
    std::vector<int32_t> col_map(num_cols, -1);
    for (npy_intp i = 0; i < ci.size; ++i) col_map[ci.data[i]] = (int32_t)i;

    std::vector<int32_t> counts(ri.size, 0);
#pragma omp parallel for num_threads(team_for(ri.size))
    for (npy_intp i = 0; i < ri.size; ++i) {
      int32_t r = ri.data[i];
      int32_t c = 0;
      for (int32_t j = p.data[r]; j < p.data[r + 1]; ++j) {
        if (col_map[ep.data[j]] >= 0) ++c;
      }
      counts[i] = c;
    }
    for (npy_intp i = 0; i < ri.size; ++i)
      new_ptr[i + 1] = new_ptr[i] + counts[i];
    new_ep.resize(new_ptr.back());
    edge_idx.resize(new_ptr.back());
#pragma omp parallel for num_threads(team_for(ri.size))
    for (npy_intp i = 0; i < ri.size; ++i) {
      int32_t r = ri.data[i];
      int32_t pos = new_ptr[i];
      for (int32_t j = p.data[r]; j < p.data[r + 1]; ++j) {
        int32_t c = col_map[ep.data[j]];
        if (c >= 0) {
          new_ep[pos] = c;
          edge_idx[pos] = j;
          ++pos;
        }
      }
    }
  }
  Py_DECREF(p.arr); Py_DECREF(ep.arr); Py_DECREF(ri.arr); Py_DECREF(ci.arr);
  return pack_steal({make_i32(new_ptr), make_i32(new_ep), make_i64(edge_idx)});
}

// Partition edges by rating value.  Returns ([sel_idx per value], [indptr per
// value]).
PyObject* py_multi_link_split(PyObject*, PyObject* args) {
  PyObject *v_obj, *p_obj, *ml_obj;
  if (!PyArg_ParseTuple(args, "OOO", &v_obj, &p_obj, &ml_obj)) return nullptr;
  F32View v, ml; I32View p;
  if (!as_f32(v_obj, &v)) return nullptr;
  if (!as_i32(p_obj, &p)) { Py_DECREF(v.arr); return nullptr; }
  if (!as_f32(ml_obj, &ml)) { Py_DECREF(v.arr); Py_DECREF(p.arr); return nullptr; }
  npy_intp rows = p.size - 1;
  int R = static_cast<int>(ml.size);
  std::vector<std::vector<int32_t>> sel(R);
  std::vector<std::vector<int32_t>> ptrs(R);
  {
    GilScopedRelease nogil;
    for (int r = 0; r < R; ++r) {
      ptrs[r].assign(rows + 1, 0);
      sel[r].reserve(v.size / (R > 0 ? R : 1) + 1);
    }
    for (npy_intp i = 0; i < rows; ++i) {
      for (int32_t j = p.data[i]; j < p.data[i + 1]; ++j) {
        for (int r = 0; r < R; ++r) {
          if (v.data[j] == ml.data[r]) {
            sel[r].push_back(j);
            ++ptrs[r][i + 1];
            break;
          }
        }
      }
    }
    for (int r = 0; r < R; ++r) {
      for (npy_intp i = 0; i < rows; ++i) ptrs[r][i + 1] += ptrs[r][i];
    }
  }
  Py_DECREF(v.arr); Py_DECREF(p.arr); Py_DECREF(ml.arr);
  PyObject* sel_list = PyList_New(R);
  PyObject* ptr_list = PyList_New(R);
  if (!sel_list || !ptr_list) {
    Py_XDECREF(sel_list); Py_XDECREF(ptr_list);
    return nullptr;
  }
  for (int r = 0; r < R; ++r) {
    PyObject* s = make_i32(sel[r]);
    PyObject* q = make_i32(ptrs[r]);
    if (!s || !q) {
      Py_XDECREF(s); Py_XDECREF(q);
      Py_DECREF(sel_list); Py_DECREF(ptr_list);
      return nullptr;
    }
    PyList_SET_ITEM(sel_list, r, s);
    PyList_SET_ITEM(ptr_list, r, q);
  }
  return pack_steal({sel_list, ptr_list});
}

// Fixed-fanout sampling without replacement, each selected row from its own
// stream.
// Returns (sampled_edge_indices i64, new_indptr i32).
PyObject* py_sample_fix_neighbor(PyObject*, PyObject* args) {
  PyObject *p_obj, *sel_obj;
  int num_neighbors;
  if (!PyArg_ParseTuple(args, "OOi", &p_obj, &sel_obj, &num_neighbors))
    return nullptr;
  I32View p, sel;
  if (!as_i32(p_obj, &p)) return nullptr;
  if (!as_i32(sel_obj, &sel)) { Py_DECREF(p.arr); return nullptr; }
  if (!rows_in_range(sel, p, "random_sample_fix_neighbor")) {
    Py_DECREF(p.arr); Py_DECREF(sel.arr); return nullptr;
  }
  std::vector<int32_t> new_ptr(sel.size + 1, 0);
  std::vector<int64_t> out;
  const CallKey key = next_call();
  {
  GilScopedRelease nogil;
  for (npy_intp i = 0; i < sel.size; ++i) {
    int32_t r = sel.data[i];
    int32_t deg = p.data[r + 1] - p.data[r];
    int32_t take = (num_neighbors < 0) ? deg : std::min(deg, num_neighbors);
    new_ptr[i + 1] = new_ptr[i] + take;
  }
  out.resize(new_ptr.back());
#pragma omp parallel for num_threads(team_for(sel.size))
  for (npy_intp i = 0; i < sel.size; ++i) {
    int32_t r = sel.data[i];
    int32_t beg = p.data[r], end = p.data[r + 1];
    int32_t take = new_ptr[i + 1] - new_ptr[i];
    int64_t* dst = out.data() + new_ptr[i];
    if (take == end - beg) {
      for (int32_t j = 0; j < take; ++j) dst[j] = beg + j;
    } else {
      // Floyd's algorithm: uniform sample of `take` distinct values from
      // [beg, end) without materialising the range.
      RowStream rng(key, static_cast<uint64_t>(i));
      std::unordered_map<int32_t, int32_t> replace_map;
      int32_t n = end - beg;
      for (int32_t j = 0; j < take; ++j) {
        int32_t k = rng.uniform(j, n - 1);
        auto it_k = replace_map.find(k);
        int32_t val_k = (it_k == replace_map.end()) ? k : it_k->second;
        auto it_j = replace_map.find(j);
        int32_t val_j = (it_j == replace_map.end()) ? j : it_j->second;
        dst[j] = beg + val_k;
        replace_map[k] = val_j;
      }
    }
  }
  }
  Py_DECREF(p.arr); Py_DECREF(sel.arr);
  return pack_steal({make_i64(out), make_i32(new_ptr)});
}

// Edge deletion producing a new indptr + keep mask.
PyObject* py_remove_edges(PyObject*, PyObject* args) {
  PyObject *p_obj, *rm_obj;
  if (!PyArg_ParseTuple(args, "OO", &p_obj, &rm_obj)) return nullptr;
  I32View p;
  if (!as_i32(p_obj, &p)) return nullptr;
  PyArrayObject* rm = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(rm_obj, NPY_INT64, NPY_ARRAY_IN_ARRAY));
  if (!rm) { Py_DECREF(p.arr); return nullptr; }
  npy_intp nnz = p.data[p.size - 1];
  std::vector<uint8_t> keep(nnz, 1);
  const int64_t* rmd = static_cast<const int64_t*>(PyArray_DATA(rm));
  const npy_intp rm_size = PyArray_SIZE(rm);
  std::vector<int32_t> new_ptr(p.size, 0);
  {
    GilScopedRelease nogil;
    for (npy_intp i = 0; i < rm_size; ++i) {
      if (rmd[i] >= 0 && rmd[i] < nnz) keep[rmd[i]] = 0;
    }
    npy_intp rows = p.size - 1;
    for (npy_intp i = 0; i < rows; ++i) {
      int32_t cnt = 0;
      for (int32_t j = p.data[i]; j < p.data[i + 1]; ++j) cnt += keep[j];
      new_ptr[i + 1] = new_ptr[i] + cnt;
    }
  }
  npy_intp dims[1] = {nnz};
  PyObject* keep_obj = PyArray_SimpleNew(1, dims, NPY_BOOL);
  if (!keep_obj) { Py_DECREF(p.arr); Py_DECREF(rm); return nullptr; }
  std::copy(keep.begin(), keep.end(),
            static_cast<uint8_t*>(PyArray_DATA(
                reinterpret_cast<PyArrayObject*>(keep_obj))));
  Py_DECREF(p.arr); Py_DECREF(rm);
  return pack_steal({make_i32(new_ptr), keep_obj});
}

// KDD'06-style random walk returning the visited edge list: with
// probability ``return_prob`` jump back to the initial node, else step to a
// uniform neighbor; collect traversed edges up to node/edge caps.  One
// stream for the whole walk.
PyObject* py_random_walk(PyObject*, PyObject* args) {
  PyObject *ep_obj, *p_obj;
  int initial_node, walk_length, max_node_num;
  long long max_edge_num;
  double return_prob;
  if (!PyArg_ParseTuple(args, "OOiidiL", &ep_obj, &p_obj, &initial_node,
                        &walk_length, &return_prob, &max_node_num,
                        &max_edge_num)) return nullptr;
  I32View ep, p;
  if (!as_i32(ep_obj, &ep)) return nullptr;
  if (!as_i32(p_obj, &p)) { Py_DECREF(ep.arr); return nullptr; }
  int node_num = static_cast<int>(p.size) - 1;
  if (initial_node >= node_num || node_num <= 0) {
    Py_DECREF(ep.arr); Py_DECREF(p.arr);
    PyErr_SetString(PyExc_IndexError,
                    "random_walk: initial_node out of range");
    return nullptr;
  }
  std::vector<int32_t> src, dst;
  const CallKey key = next_call();
  {
  GilScopedRelease nogil;
  RowStream rng(key, 0);
  if (initial_node < 0) initial_node = rng.uniform(0, node_num - 1);
  std::unordered_set<int64_t> edge_set;
  std::unordered_set<int32_t> node_set{initial_node};
  int cur = initial_node;
  for (int i = 0; i < walk_length; ++i) {
    int nxt;
    bool returned = rng.unit() < return_prob;
    if (returned) {
      nxt = initial_node;
    } else {
      int beg = p.data[cur], end = p.data[cur + 1];
      if (end <= beg) break;
      nxt = ep.data[rng.uniform(beg, end - 1)];
      int64_t key = static_cast<int64_t>(cur) * node_num + nxt;
      if (!edge_set.count(key)) {
        if (static_cast<long long>(edge_set.size()) >= max_edge_num) break;
        node_set.insert(nxt);
        if (static_cast<int>(node_set.size()) > max_node_num) break;
        edge_set.insert(key);
        src.push_back(cur);
        dst.push_back(nxt);
      }
    }
    cur = nxt;
  }
  }
  Py_DECREF(ep.arr); Py_DECREF(p.arr);
  return pack_steal({make_i32(src), make_i32(dst)});
}

// Visited-node collection along a plain random walk (one stream).
PyObject* py_get_random_walk_nodes(PyObject*, PyObject* args) {
  PyObject *ep_obj, *p_obj;
  int initial_node, max_node_num, walk_length;
  if (!PyArg_ParseTuple(args, "OOiii", &ep_obj, &p_obj, &initial_node,
                        &max_node_num, &walk_length)) return nullptr;
  I32View ep, p;
  if (!as_i32(ep_obj, &ep)) return nullptr;
  if (!as_i32(p_obj, &p)) { Py_DECREF(ep.arr); return nullptr; }
  if (initial_node < 0 || initial_node >= p.size - 1) {
    Py_DECREF(ep.arr); Py_DECREF(p.arr);
    PyErr_SetString(PyExc_IndexError,
                    "get_random_walk_nodes: initial_node out of range");
    return nullptr;
  }
  std::vector<int32_t> order{initial_node};
  const CallKey key = next_call();
  {
    GilScopedRelease nogil;
    RowStream rng(key, 0);
    std::unordered_set<int32_t> seen{initial_node};
    int cur = initial_node;
    for (int i = 0; i < walk_length; ++i) {
      int beg = p.data[cur], end = p.data[cur + 1];
      if (end <= beg) break;
      cur = ep.data[rng.uniform(beg, end - 1)];
      if (seen.insert(cur).second) order.push_back(cur);
      if (static_cast<int>(seen.size()) >= max_node_num) break;
    }
  }
  Py_DECREF(ep.arr); Py_DECREF(p.arr);
  return make_i32(order);
}

// Positive + uniform-negative edge sets per target node: negatives drawn
// uniformly from NON-neighbors via a swap-pool over [0, node_num), each
// target row from its own stream.
PyObject* py_uniform_neg_sampling(PyObject*, PyObject* args) {
  PyObject *ep_obj, *p_obj, *tgt_obj;
  int node_num, replace;
  double scale;
  if (!PyArg_ParseTuple(args, "OOOidi", &ep_obj, &p_obj, &tgt_obj,
                        &node_num, &scale, &replace)) return nullptr;
  I32View ep, p, tgt;
  if (!as_i32(ep_obj, &ep)) return nullptr;
  if (!as_i32(p_obj, &p)) { Py_DECREF(ep.arr); return nullptr; }
  if (!as_i32(tgt_obj, &tgt)) {
    Py_DECREF(ep.arr); Py_DECREF(p.arr); return nullptr;
  }
  if (!rows_in_range(tgt, p, "uniform_neg_sampling")) {
    Py_DECREF(ep.arr); Py_DECREF(p.arr); Py_DECREF(tgt.arr); return nullptr;
  }
  std::vector<int32_t> out_ep, out_label, out_cnt, out_ptr(tgt.size + 1, 0);
  const CallKey key = next_call();
  {
  GilScopedRelease nogil;
  for (npy_intp i = 0; i < tgt.size; ++i) {
    RowStream rng(key, static_cast<uint64_t>(i));
    int ind = tgt.data[i];
    int beg = p.data[ind], end = p.data[ind + 1];
    int pos = end - beg;
    if (pos > 0) {
      int want = std::min(
          static_cast<int>(std::ceil(pos * scale)), node_num);
      for (int j = beg; j < end; ++j) {
        out_ep.push_back(ep.data[j]);
        out_label.push_back(1);
        out_cnt.push_back(1);
      }
      // Swap-pool: virtually permute [0, node_num) so the first ``pos``
      // slots hold the positives, then draw from [pos, node_num).
      std::unordered_map<int, int> pool, pos_of;
      for (int j = 0; j < pos; ++j) {
        int val = ep.data[beg + j];
        auto itv = pos_of.find(val);
        int val_pos = (itv == pos_of.end()) ? val : itv->second;
        if (val_pos < pos && val_pos != j) { /* already placed */ }
        auto itj = pool.find(j);
        int jth_val = (itj == pool.end()) ? j : itj->second;
        pos_of[val] = j;
        pos_of[jth_val] = val_pos;
        pool[val_pos] = jth_val;
        pool[j] = val;
      }
      auto lookup = [&pool](int v) {
        auto it = pool.find(v);
        return it == pool.end() ? v : it->second;
      };
      if (replace) {
        std::unordered_map<int, int> counts;
        for (int j = 0; j < want && pos < node_num; ++j) {
          ++counts[lookup(rng.uniform(pos, node_num - 1))];
        }
        for (const auto& kv : counts) {
          out_ep.push_back(kv.first);
          out_label.push_back(-1);
          out_cnt.push_back(kv.second);
        }
      } else {
        int lower = pos;
        for (int j = 0; j < want && lower < node_num; ++j, ++lower) {
          int v = rng.uniform(lower, node_num - 1);
          out_ep.push_back(lookup(v));
          out_label.push_back(-1);
          out_cnt.push_back(1);
          auto itl = pool.find(lower);
          pool[v] = (itl == pool.end()) ? lower : itl->second;
        }
      }
    }
    out_ptr[i + 1] = static_cast<int32_t>(out_ep.size());
  }
  }
  Py_DECREF(ep.arr); Py_DECREF(p.arr); Py_DECREF(tgt.arr);
  return pack_steal({make_i32(out_ep), make_i32(out_ptr),
                     make_i32(out_label), make_i32(out_cnt)});
}

// Sample fixed-fanout neighbors of selected nodes and merge them (plus
// the selected nodes) into a first-occurrence-unique id list, each
// selected row drawn from its own stream.
// Returns (dst_end_points [positions in merged], dst_ind_ptr,
//          merged_node_ids, indices_in_merged [per selected node]).
PyObject* py_sample_and_merge(PyObject*, PyObject* args) {
  PyObject *ep_obj, *p_obj, *ids_obj, *sel_obj;
  int neighbor_num;
  if (!PyArg_ParseTuple(args, "OOOOi", &ep_obj, &p_obj, &ids_obj,
                        &sel_obj, &neighbor_num)) return nullptr;
  I32View ep, p, ids, sel;
  if (!as_i32(ep_obj, &ep)) return nullptr;
  if (!as_i32(p_obj, &p)) { Py_DECREF(ep.arr); return nullptr; }
  if (!as_i32(ids_obj, &ids)) {
    Py_DECREF(ep.arr); Py_DECREF(p.arr); return nullptr;
  }
  if (!as_i32(sel_obj, &sel)) {
    Py_DECREF(ep.arr); Py_DECREF(p.arr); Py_DECREF(ids.arr);
    return nullptr;
  }
  if (!rows_in_range(sel, p, "random_sel_neighbor_and_merge")) {
    Py_DECREF(ep.arr); Py_DECREF(p.arr); Py_DECREF(ids.arr);
    Py_DECREF(sel.arr); return nullptr;
  }
  std::vector<int32_t> merged_ids;
  std::vector<int32_t> dst_ep, dst_ptr(sel.size + 1, 0), sel_in_merged;
  const CallKey key = next_call();
  {
  GilScopedRelease nogil;
  std::unordered_map<int32_t, int32_t> merged_map;
  auto intern = [&](int32_t node_id) {
    auto it = merged_map.find(node_id);
    if (it != merged_map.end()) return it->second;
    int32_t idx = static_cast<int32_t>(merged_ids.size());
    merged_map.emplace(node_id, idx);
    merged_ids.push_back(node_id);
    return idx;
  };
  for (npy_intp i = 0; i < sel.size; ++i) {
    int ind = sel.data[i];
    sel_in_merged.push_back(intern(ids.data[ind]));
    int beg = p.data[ind], end = p.data[ind + 1];
    int deg = end - beg;
    int take = (neighbor_num < 0) ? deg : std::min(deg, neighbor_num);
    if (take == deg) {
      for (int j = beg; j < end; ++j)
        dst_ep.push_back(intern(ids.data[ep.data[j]]));
    } else {
      RowStream rng(key, static_cast<uint64_t>(i));
      std::unordered_map<int, int> pool;
      for (int lower = 0; lower < take; ++lower) {
        int v = rng.uniform(lower, deg - 1);
        auto it = pool.find(v);
        int pick = (it == pool.end()) ? v : it->second;
        dst_ep.push_back(intern(ids.data[ep.data[beg + pick]]));
        auto itl = pool.find(lower);
        pool[v] = (itl == pool.end()) ? lower : itl->second;
      }
    }
    dst_ptr[i + 1] = static_cast<int32_t>(dst_ep.size());
  }
  }
  Py_DECREF(ep.arr); Py_DECREF(p.arr); Py_DECREF(ids.arr);
  Py_DECREF(sel.arr);
  return pack_steal({make_i32(dst_ep), make_i32(dst_ptr),
                     make_i32(merged_ids), make_i32(sel_in_merged)});
}

// Chunked-ELL packing: split each destination's edge segment into width-K
// virtual rows (the layout of the ``ell`` backend, which the port builds
// on the card, ops/chunked_ell.py).  A stable counting placement in O(E)
// instead of an argsort: deg histogram -> row
// offsets -> one ordered pass placing each edge at
// (row_offset[dst] + rank/K, rank%K).  Returns FLAT arrays
// (src_idx (V_pad*K,), rating (V_pad*K,), row_dst (V_pad,), V_pad) —
// the Python wrapper reshapes.  Padded slots hold the ``num_src``
// sentinel / rating 0, padded rows dst 0, matching the NumPy packer
// bit-for-bit (placement order is the input edge order, as with the
// stable argsort).
PyObject* py_build_chunked_ell(PyObject*, PyObject* args) {
  PyObject *src_obj, *dst_obj, *rat_obj, *mask_obj;
  int num_src, num_dst, K, row_pad;
  if (!PyArg_ParseTuple(args, "OOOOiiii", &src_obj, &dst_obj, &rat_obj,
                        &mask_obj, &num_src, &num_dst, &K, &row_pad))
    return nullptr;
  I32View src, dst, rat;
  if (!as_i32(src_obj, &src)) return nullptr;
  if (!as_i32(dst_obj, &dst)) { Py_DECREF(src.arr); return nullptr; }
  if (!as_i32(rat_obj, &rat)) {
    Py_DECREF(src.arr); Py_DECREF(dst.arr); return nullptr;
  }
  F32View mask{nullptr, nullptr, 0};
  bool has_mask = (mask_obj != Py_None);
  if (has_mask && !as_f32(mask_obj, &mask)) {
    Py_DECREF(src.arr); Py_DECREF(dst.arr); Py_DECREF(rat.arr);
    return nullptr;
  }
  const npy_intp E = src.size;
  auto release_inputs = [&]() {
    Py_DECREF(src.arr); Py_DECREF(dst.arr); Py_DECREF(rat.arr);
    if (has_mask) Py_DECREF(mask.arr);
  };
  if (dst.size != E || rat.size != E || (has_mask && mask.size != E) ||
      K <= 0 || row_pad <= 0 || num_dst < 0 || num_src < 0) {
    release_inputs();
    PyErr_SetString(PyExc_ValueError,
                    "build_chunked_ell: shape/argument mismatch");
    return nullptr;
  }

  // 1. masked degree histogram per destination (parallel partials)
  std::vector<int64_t> deg(static_cast<size_t>(num_dst), 0);
  std::vector<int64_t> row_offset(static_cast<size_t>(num_dst) + 1, 0);
  int64_t n_real = 0;
  int64_t V_pad = 0;
  {
    GilScopedRelease nogil;
    const int nt = team_for(E);
    std::vector<std::vector<int64_t>> part(
        nt, std::vector<int64_t>(static_cast<size_t>(num_dst), 0));
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
    {
      std::vector<int64_t>& my = part[omp_get_thread_num()];
#pragma omp for
      for (npy_intp i = 0; i < E; ++i) {
        if (!has_mask || mask.data[i] > 0.0f) ++my[dst.data[i]];
      }
    }
#else
    for (npy_intp i = 0; i < E; ++i) {
      if (!has_mask || mask.data[i] > 0.0f) ++part[0][dst.data[i]];
    }
#endif
#ifdef _OPENMP
#pragma omp parallel for num_threads(team_for(num_dst))
#endif
    for (int d = 0; d < num_dst; ++d) {
      int64_t s = 0;
      for (int t = 0; t < nt; ++t) s += part[t][d];
      deg[d] = s;
    }

    // 2. virtual-row offsets
    for (int d = 0; d < num_dst; ++d) {
      row_offset[d + 1] = row_offset[d] + (deg[d] + K - 1) / K;
      n_real += deg[d];
    }
    V_pad = ((row_offset[num_dst] + row_pad - 1) / row_pad) * row_pad;
    if (V_pad < row_pad) V_pad = row_pad;
  }
  const int64_t V = row_offset[num_dst];

  npy_intp slot_dims[1] = {static_cast<npy_intp>(V_pad) * K};
  npy_intp row_dims[1] = {static_cast<npy_intp>(V_pad)};
  PyObject* idx_arr = PyArray_SimpleNew(1, slot_dims, NPY_INT32);
  PyObject* rat_arr = PyArray_SimpleNew(1, slot_dims, NPY_INT32);
  PyObject* row_arr = PyArray_SimpleNew(1, row_dims, NPY_INT32);
  if (!idx_arr || !rat_arr || !row_arr) {
    release_inputs();
    Py_XDECREF(idx_arr); Py_XDECREF(rat_arr); Py_XDECREF(row_arr);
    if (!PyErr_Occurred()) PyErr_NoMemory();
    return nullptr;
  }
  int32_t* idx_out = static_cast<int32_t*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(idx_arr)));
  int32_t* rat_out = static_cast<int32_t*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(rat_arr)));
  int32_t* row_out = static_cast<int32_t*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(row_arr)));
  {
  GilScopedRelease nogil;
#ifdef _OPENMP
#pragma omp parallel for num_threads(team_for(V_pad * K))
#endif
  for (int64_t s = 0; s < V_pad * K; ++s) {
    idx_out[s] = num_src;  // zero-row sentinel
    rat_out[s] = 0;
  }

  // 3. ordered placement (sequential pass keeps the stable edge order
  // of the NumPy packer; O(E) and memory-bound, ~100 ms at 10M edges)
  std::vector<int64_t> cursor(static_cast<size_t>(num_dst), 0);
  for (npy_intp i = 0; i < E; ++i) {
    if (has_mask && !(mask.data[i] > 0.0f)) continue;
    const int32_t d = dst.data[i];
    const int64_t r = cursor[d]++;
    const int64_t s = (row_offset[d] + r / K) * K + (r % K);
    idx_out[s] = src.data[i];
    rat_out[s] = rat.data[i];
  }

  // 4. virtual-row -> destination map (padded rows: 0)
#ifdef _OPENMP
#pragma omp parallel for num_threads(team_for(num_dst))
#endif
  for (int d = 0; d < num_dst; ++d) {
    for (int64_t v = row_offset[d]; v < row_offset[d + 1]; ++v)
      row_out[v] = d;
  }
  // Padded rows keep row ids non-decreasing (consumers pass
  // indices_are_sorted to the segment sum); their slots are all
  // sentinels, so they contribute nothing to the last segment.
  const int32_t pad_row = num_dst > 0 ? num_dst - 1 : 0;
  for (int64_t v = V; v < V_pad; ++v) row_out[v] = pad_row;
  }

  release_inputs();
  return pack_steal({idx_arr, rat_arr, row_arr,
                     PyLong_FromLongLong(n_real)});
}

// Bit-packed dense adjacency for the bitdense backend (ops/bitdense.py:
// pack_bits): bit b of P[(r * d8 + d % d8), s] is set iff edge
// (dst = d with d / d8 == b  <-  src = s) carries rating level r.  One
// O(E) pass with atomic byte ORs (duplicate edges collapse, matching the
// one-hot semantics of the dense adjacency).
// ``interleave`` > 0 applies a column-pairing permutation: within each block of
// ``interleave`` source columns, logical column L maps to physical
// 2*L (first half) / 2*(L - half) + 1 (second half), so one u16 lane
// holds the bytes of logical columns L and L + half and both bit-plane
// extractions are contiguous.
// ``row_interleave`` > 0 (= kernel row block bm) permutes the packed-row
// coordinate: within each bm-row block, natural position w maps to
// physical 2*(w % (bm/2)) + w/(bm/2), the layout of KERNEL.BIT_IMPL:
// pallas16 (ops/csrc/bit_walk.cuh:physical_row reads it).
PyObject* py_pack_bits(PyObject*, PyObject* args) {
  PyObject *dst_obj, *src_obj, *rat_obj, *mask_obj;
  int num_links, d8, s_pad, interleave = 0, row_interleave = 0;
  if (!PyArg_ParseTuple(args, "OOOOiii|ii", &dst_obj, &src_obj, &rat_obj,
                        &mask_obj, &num_links, &d8, &s_pad, &interleave,
                        &row_interleave))
    return nullptr;
  I32View dst, src, rat;
  if (!as_i32(dst_obj, &dst)) return nullptr;
  if (!as_i32(src_obj, &src)) { Py_DECREF(dst.arr); return nullptr; }
  if (!as_i32(rat_obj, &rat)) {
    Py_DECREF(dst.arr); Py_DECREF(src.arr); return nullptr;
  }
  F32View mask{nullptr, nullptr, 0};
  bool has_mask = (mask_obj != Py_None);
  if (has_mask && !as_f32(mask_obj, &mask)) {
    Py_DECREF(dst.arr); Py_DECREF(src.arr); Py_DECREF(rat.arr);
    return nullptr;
  }
  const npy_intp E = dst.size;
  auto release_inputs = [&]() {
    Py_DECREF(dst.arr); Py_DECREF(src.arr); Py_DECREF(rat.arr);
    if (has_mask) Py_DECREF(mask.arr);
  };
  if (src.size != E || rat.size != E || (has_mask && mask.size != E) ||
      num_links <= 0 || d8 <= 0 || s_pad <= 0) {
    release_inputs();
    PyErr_SetString(PyExc_ValueError, "pack_bits: shape/arg mismatch");
    return nullptr;
  }
  npy_intp dims[2] = {static_cast<npy_intp>(num_links) * d8, s_pad};
  PyObject* p_arr = PyArray_ZEROS(2, dims, NPY_UINT8, 0);
  if (!p_arr) { release_inputs(); return nullptr; }
  uint8_t* P = static_cast<uint8_t*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(p_arr)));
  const int64_t d8l = d8, spl = s_pad;
  const int64_t il = interleave, half = il / 2;
  const int64_t ril = row_interleave, rhalf = ril / 2;
  bool out_of_range = false;
  {
  GilScopedRelease nogil;
#ifdef _OPENMP
#pragma omp parallel for num_threads(team_for(E)) \
    reduction(|| : out_of_range)
#endif
  for (npy_intp e = 0; e < E; ++e) {
    if (has_mask && mask.data[e] <= 0.0f) continue;
    const int64_t d = dst.data[e];
    const int64_t r = rat.data[e];
    if (d < 0 || d >= 8 * d8l || src.data[e] < 0 || r < 0 ||
        r >= num_links) {
      out_of_range = true;
      continue;
    }
    int64_t s = src.data[e];
    if (il > 0) {
      const int64_t blk = s / il, off = s % il;
      s = blk * il + (off < half ? 2 * off : 2 * (off - half) + 1);
    }
    int64_t pos = d % d8l;
    if (ril > 0) {
      const int64_t blk = pos / ril, w = pos % ril;
      pos = blk * ril + 2 * (w % rhalf) + w / rhalf;
    }
    if (s >= spl || pos >= d8l) {
      out_of_range = true;
      continue;
    }
    const int64_t idx = (r * d8l + pos) * spl + s;
    const uint8_t bit = static_cast<uint8_t>(1u << (d / d8l));
#ifdef _OPENMP
    __atomic_fetch_or(&P[idx], bit, __ATOMIC_RELAXED);
#else
    P[idx] |= bit;
#endif
  }
  }
  release_inputs();
  if (out_of_range) {
    Py_DECREF(p_arr);
    PyErr_SetString(PyExc_ValueError,
                    "pack_bits: an edge lies outside the packed layout");
    return nullptr;
  }
  return p_arr;
}

// Fused sampled-plan block planner for ``BlockSampler.sample``
// (graph/sampling.py).  For each selected destination row: sample <=K
// neighbor edges without replacement (Floyd), gather their global ids /
// rating levels, compute the (optionally removal-adjusted) GCN support
// as inv_row[row] * inv_col[col], zero the support of excluded batch
// edges (binary search in a sorted key set — REMOVE_RATING semantics),
// intern each neighbor id into the growing next-level frontier
// (first-occurrence order seeded with the current frontier: the
// contract of unique_inverse(concat(frontier, nbr_ids))), and scatter
// positions/weights/ratings into fixed-shape ELL rows.  One call
// replaces the sample + gather + searchsorted + unique_inverse +
// ELL-scatter numpy pipeline.  Row i draws from RowStream(call, i).
// Returns (nbr_pos i32[n_dst*K], weight f32[n_dst*K],
//          rating i32[n_dst*K], merged_ids i32[n_merged]).
PyObject* py_sample_block_ell(PyObject*, PyObject* args) {
  PyObject *p_obj, *ep_obj, *cid_obj, *rat_obj, *ir_obj, *ic_obj,
      *sel_obj, *fr_obj, *ex_obj;
  long long id_cap, key_mult;
  int fanout, n_dst, row_is_user;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOLiiiL", &p_obj, &ep_obj, &cid_obj,
                        &rat_obj, &ir_obj, &ic_obj, &sel_obj, &fr_obj,
                        &ex_obj, &id_cap, &fanout, &n_dst, &row_is_user,
                        &key_mult))
    return nullptr;
  I32View p, ep, cid, rat, sel, fr;
  F32View ir, ic;
  if (!as_i32(p_obj, &p)) return nullptr;
  if (!as_i32(ep_obj, &ep)) { Py_DECREF(p.arr); return nullptr; }
  if (!as_i32(cid_obj, &cid)) {
    Py_DECREF(p.arr); Py_DECREF(ep.arr); return nullptr;
  }
  if (!as_i32(rat_obj, &rat)) {
    Py_DECREF(p.arr); Py_DECREF(ep.arr); Py_DECREF(cid.arr); return nullptr;
  }
  auto release4 = [&]() {
    Py_DECREF(p.arr); Py_DECREF(ep.arr); Py_DECREF(cid.arr);
    Py_DECREF(rat.arr);
  };
  if (!as_f32(ir_obj, &ir)) { release4(); return nullptr; }
  if (!as_f32(ic_obj, &ic)) { release4(); Py_DECREF(ir.arr); return nullptr; }
  if (!as_i32(sel_obj, &sel)) {
    release4(); Py_DECREF(ir.arr); Py_DECREF(ic.arr); return nullptr;
  }
  if (!as_i32(fr_obj, &fr)) {
    release4(); Py_DECREF(ir.arr); Py_DECREF(ic.arr); Py_DECREF(sel.arr);
    return nullptr;
  }
  PyArrayObject* ex = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(ex_obj, NPY_INT64, NPY_ARRAY_IN_ARRAY));
  auto release_all = [&]() {
    release4(); Py_DECREF(ir.arr); Py_DECREF(ic.arr); Py_DECREF(sel.arr);
    Py_DECREF(fr.arr); Py_XDECREF(ex);
  };
  if (!ex) { release_all(); return nullptr; }
  const int64_t* exd = static_cast<const int64_t*>(PyArray_DATA(ex));
  const npy_intp ex_size = PyArray_SIZE(ex);
  if (fanout <= 0 || fanout > 4096 || n_dst < sel.size || id_cap <= 0) {
    release_all();
    PyErr_SetString(PyExc_ValueError,
                    "sample_block_ell: fanout must be in (0, 4096] and "
                    "n_dst >= len(sel_rows)");
    return nullptr;
  }
  if (!rows_in_range(sel, p, "sample_block_ell")) {
    release_all();
    return nullptr;
  }
  const int K = fanout;
  npy_intp slot_dims[1] = {static_cast<npy_intp>(n_dst) * K};
  PyObject* pos_arr = PyArray_ZEROS(1, slot_dims, NPY_INT32, 0);
  PyObject* w_arr = PyArray_ZEROS(1, slot_dims, NPY_FLOAT32, 0);
  PyObject* rat_arr = PyArray_ZEROS(1, slot_dims, NPY_INT32, 0);
  if (!pos_arr || !w_arr || !rat_arr) {
    release_all();
    Py_XDECREF(pos_arr); Py_XDECREF(w_arr); Py_XDECREF(rat_arr);
    if (!PyErr_Occurred()) PyErr_NoMemory();
    return nullptr;
  }
  int32_t* pos_out = static_cast<int32_t*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(pos_arr)));
  float* w_out = static_cast<float*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(w_arr)));
  int32_t* rat_out = static_cast<int32_t*>(
      PyArray_DATA(reinterpret_cast<PyArrayObject*>(rat_arr)));
  std::vector<int32_t> merged;
  bool oob = false;
  const CallKey key = next_call();
  {
    GilScopedRelease nogil;
    // Phase A (parallel over rows; each row owns its K ELL slots):
    // sample edges, gather neighbor ids/ratings into the output slots
    // (gid staged in pos_out), compute supports, zero excluded edges.
    std::vector<int32_t> n_take(static_cast<size_t>(sel.size), 0);
#pragma omp parallel num_threads(team_for(sel.size))
    {
      int32_t picks[4096];
#pragma omp for schedule(static)
      for (npy_intp i = 0; i < sel.size; ++i) {
        const int32_t r = sel.data[i];
        const int32_t beg = p.data[r], end = p.data[r + 1];
        const int32_t deg = end - beg;
        const int32_t take = std::min(deg, K);
        n_take[i] = take;
        RowStream rng(key, static_cast<uint64_t>(i));
        if (take == deg) {
          for (int32_t k = 0; k < take; ++k) picks[k] = beg + k;
        } else if (take <= 32) {
          // Floyd's uniform sample of `take` distinct edges from
          // [beg, end).  The swap map holds at most `take` (<= K,
          // typically 8) entries, so a linear-scan pair array beats a
          // heap-allocated hash map by an order of magnitude.
          int32_t map_k[32], map_v[32];
          int n_map = 0;
          auto map_get = [&](int32_t key) {
            for (int m = 0; m < n_map; ++m)
              if (map_k[m] == key) return map_v[m];
            return key;
          };
          for (int32_t k = 0; k < take; ++k) {
            const int32_t v = rng.uniform(k, deg - 1);
            const int32_t val_v = map_get(v);
            const int32_t val_k = map_get(k);
            picks[k] = beg + val_v;
            int put = -1;
            for (int m = 0; m < n_map; ++m)
              if (map_k[m] == v) { put = m; break; }
            if (put < 0) { put = n_map++; map_k[put] = v; }
            map_v[put] = val_k;
          }
        } else {
          std::unordered_map<int32_t, int32_t> replace_map;
          for (int32_t k = 0; k < take; ++k) {
            const int32_t v = rng.uniform(k, deg - 1);
            auto it_v = replace_map.find(v);
            const int32_t val_v =
                (it_v == replace_map.end()) ? v : it_v->second;
            auto it_k = replace_map.find(k);
            const int32_t val_k =
                (it_k == replace_map.end()) ? k : it_k->second;
            picks[k] = beg + val_v;
            replace_map[v] = val_k;
          }
        }
        const float inv_r = ir.data[r];
        for (int32_t k = 0; k < take; ++k) {
          const int32_t j = picks[k];
          const int32_t c = ep.data[j];
          float w = inv_r * ic.data[c];
          if (ex_size) {
            const int64_t key =
                row_is_user
                    ? static_cast<int64_t>(r) * key_mult + c
                    : static_cast<int64_t>(c) * key_mult + r;
            if (std::binary_search(exd, exd + ex_size, key)) w = 0.0f;
          }
          const npy_intp s = static_cast<npy_intp>(i) * K + k;
          pos_out[s] = cid.data[c];  // staged gid; interned in phase B
          w_out[s] = w;
          rat_out[s] = rat.data[j];
        }
      }
    }

    // Phase B (sequential): first-occurrence intern of the staged gids
    // into the next frontier, seeded with the current one — the
    // contract of unique_inverse(concat(frontier, nbr_ids)).
    merged.reserve(static_cast<size_t>(fr.size) +
                   static_cast<size_t>(sel.size) * K);
    std::vector<int32_t> pos_map(static_cast<size_t>(id_cap), -1);
    auto intern = [&](int32_t gid) -> int32_t {
      if (gid < 0 || gid >= id_cap) { oob = true; return 0; }
      int32_t q = pos_map[gid];
      if (q < 0) {
        q = static_cast<int32_t>(merged.size());
        pos_map[gid] = q;
        merged.push_back(gid);
      }
      return q;
    };
    for (npy_intp i = 0; i < fr.size; ++i) intern(fr.data[i]);
    for (npy_intp i = 0; i < sel.size && !oob; ++i) {
      const int32_t take = n_take[i];
      for (int32_t k = 0; k < take; ++k) {
        const npy_intp s = static_cast<npy_intp>(i) * K + k;
        pos_out[s] = intern(pos_out[s]);
      }
    }
  }
  release_all();
  if (oob) {
    Py_DECREF(pos_arr); Py_DECREF(w_arr); Py_DECREF(rat_arr);
    PyErr_SetString(PyExc_ValueError,
                    "sample_block_ell: node id out of range of id_cap");
    return nullptr;
  }
  return pack_steal({pos_arr, w_arr, rat_arr, make_i32(merged)});
}

PyMethodDef kMethods[] = {
    {"random_walk", py_random_walk, METH_VARARGS,
     "KDD'06 random-walk subgraph sampling -> (src, dst) edges."},
    {"get_random_walk_nodes", py_get_random_walk_nodes, METH_VARARGS,
     "Nodes visited along a random walk."},
    {"uniform_neg_sampling", py_uniform_neg_sampling, METH_VARARGS,
     "Positive + uniform negative edges per target node."},
    {"random_sel_neighbor_and_merge", py_sample_and_merge, METH_VARARGS,
     "Fanout sampling + merge into unique node frontier."},
    {"set_seed", py_set_seed, METH_VARARGS,
     "Restart the draws: seed, and random calls counted from 0."},
    {"unique_inverse", py_unique_inverse, METH_VARARGS,
     "First-occurrence unique + inverse indices."},
    {"unique_cnt", py_unique_cnt, METH_VARARGS,
     "First-occurrence unique + counts."},
    {"take_1d", py_take_1d, METH_VARARGS, "Parallel 1-D gather."},
    {"gen_row_indices_by_indptr", py_gen_row_indices, METH_VARARGS,
     "CSR indptr -> COO row indices."},
    {"seg_sum", py_seg_sum, METH_VARARGS, "Segment sum."},
    {"seg_add", py_seg_add, METH_VARARGS, "Segment broadcast add."},
    {"seg_mul", py_seg_mul, METH_VARARGS, "Segment broadcast mul."},
    {"get_support", py_get_support, METH_VARARGS,
     "Per-edge GCN degree normalisation."},
    {"csr_submat", py_csr_submat, METH_VARARGS,
     "Row/col submatrix with column remapping."},
    {"multi_link_split", py_multi_link_split, METH_VARARGS,
     "Partition edges by rating value."},
    {"random_sample_fix_neighbor", py_sample_fix_neighbor, METH_VARARGS,
     "Fixed-fanout neighbor sampling without replacement."},
    {"remove_edges_by_indices", py_remove_edges, METH_VARARGS,
     "Edge removal -> (new indptr, keep mask)."},
    {"build_chunked_ell", py_build_chunked_ell, METH_VARARGS,
     "Pack (masked) COO edges into width-K chunked-ELL virtual rows."},
    {"pack_bits", py_pack_bits, METH_VARARGS,
     "Bit-pack a (masked) multi-link adjacency, 8 dst planes per byte."},
    {"sample_block_ell", py_sample_block_ell, METH_VARARGS,
     "Fused sampled-plan block: sample+support+exclude+merge+ELL."},
    {"set_omp_threads", py_set_omp_threads, METH_VARARGS,
     "Cap OpenMP team size for kernels called from this thread."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_torch_graph_kernels",
                       "stargcn_tpu_torch host graph kernels", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__torch_graph_kernels(void) {
  import_array();
  return PyModule_Create(&kModule);
}
