/* Native engine-core kernels for the hot per-row paths.
 *
 * The reference implements its entire dataflow hot loop natively (Rust,
 * src/engine/dataflow.rs); here the control plane stays in Python but the
 * per-row floors — entry construction, consolidation, state-map
 * application, filter sweeps — run as CPython C++ kernels over the same
 * object representation (list of (key, row, diff) tuples). Columnar math
 * lives in engine/device.py (NumPy) and engine/device_ops.py (the card);
 * these kernels cover the object plumbing numpy cannot.
 *
 * Built at first use by pathway_tpu_torch/native/__init__.py through
 * pathway_tpu_torch/_build.py::build_host (g++ -O3 into _build/); a failed
 * build raises, and PATHWAY_TPU_DISABLE_NATIVE=1 is the one way to the
 * pure-Python implementations.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <ctime>
#include <vector>

namespace {

/* -- per-kernel hit counters -------------------------------------------------
 *
 * Cheap engagement probes: every kernel entry bumps its slot, and
 * ``hit_counts()`` exposes the table as a dict. bench_dataflow records it
 * next to EXCHANGE_STATS so a silent import regression (everything
 * falling back to Python loops) is visible in the bench JSON, and the
 * smoke test asserts the counters actually move on a groupby+join run.
 */

enum HitKernel {
  H_EXTRACT_COLUMN = 0,
  H_ENTRY_DIFFS,
  H_CONSOLIDATE,
  H_APPLY_STATE,
  H_BUILD_ENTRIES,
  H_FILTER_TRUTHY,
  H_JOIN_INSERT_INNER,
  H_POINTERS_TO_BYTES,
  H_BYTES_TO_POINTERS,
  H_ENTRY_KEYS_BYTES,
  H_HASH_JOIN_PAIRS,
  H_COLUMNS_TO_ENTRIES,
  H_HASH_TUPLES_BATCH,
  H_SHARD_VALUES,
  H_ENTRIES_TO_SIDE,
  H_MATCH_PAIRS_I64,
  H_SESSION_OVERLAY,
  H_N_KERNELS,
};

const char *const HIT_NAMES[H_N_KERNELS] = {
    "extract_column",   "entry_diffs",      "consolidate",
    "apply_state",      "build_entries",    "filter_truthy",
    "join_insert_inner", "pointers_to_bytes", "bytes_to_pointers",
    "entry_keys_bytes", "hash_join_pairs",  "columns_to_entries",
    "hash_tuples_batch", "shard_values",    "entries_to_side",
    "match_pairs_i64",  "session_overlay",
};

unsigned long long g_hits[H_N_KERNELS] = {0};

/* cumulative wall nanoseconds inside each kernel (scope of the HIT
 * declaration to scope exit), feeding kernel_ns() and from there the
 * pathway_native_kernel_ns_total registry series */
unsigned long long g_ns[H_N_KERNELS] = {0};

struct KTimer {
  int id;
  struct timespec t0;
  explicit KTimer(int id_) : id(id_) {
    g_hits[id_]++;
    clock_gettime(CLOCK_MONOTONIC, &t0);
  }
  ~KTimer() {
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    long long d = (long long)(t1.tv_sec - t0.tv_sec) * 1000000000LL +
                  (long long)(t1.tv_nsec - t0.tv_nsec);
    if (d > 0) g_ns[id] += (unsigned long long)d;
  }
};

/* HIT(id) declares an RAII probe: bumps the hit counter on entry and
 * accumulates nanoseconds until the enclosing scope exits. Every call
 * site is a standalone statement, so the declaration is safe; __LINE__
 * keeps names unique within one scope. */
#define PW_HIT_CAT2(a, b) a##b
#define PW_HIT_CAT(a, b) PW_HIT_CAT2(a, b)
#define HIT(id) KTimer PW_HIT_CAT(_pw_ktimer_, __LINE__)(id)

PyObject *counts_dict(const unsigned long long table[H_N_KERNELS]) {
  PyObject *out = PyDict_New();
  if (!out) return nullptr;
  for (int i = 0; i < H_N_KERNELS; i++) {
    PyObject *v = PyLong_FromUnsignedLongLong(table[i]);
    if (!v || PyDict_SetItemString(out, HIT_NAMES[i], v) < 0) {
      Py_XDECREF(v);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(v);
  }
  return out;
}

PyObject *hit_counts(PyObject *, PyObject *) { return counts_dict(g_hits); }

PyObject *kernel_ns(PyObject *, PyObject *) { return counts_dict(g_ns); }

PyObject *reset_hit_counts(PyObject *, PyObject *) {
  for (int i = 0; i < H_N_KERNELS; i++) {
    g_hits[i] = 0;
    g_ns[i] = 0;
  }
  Py_RETURN_NONE;
}

/* -- columnar extraction -----------------------------------------------------
 *
 * One C pass replaces the Python `[row[c] for row in rows]` + np.asarray
 * dance of engine/device.py::_extract. Exact-type discipline matches the
 * Python path: only genuine int/float/bool cells columnarise (subclasses —
 * Pointer(int) keys, np scalars — and str/None/ERROR fall back), so the
 * row interpreter keeps ownership of every edge case.
 */

enum ColKind { K_UNSET = 0, K_INT, K_FLOAT, K_BOOL, K_FAIL };

/* Extract rows[i][col] (item_idx < 0) or entries[i][1][col] into a fresh
 * typed ndarray; NULL+no-error means "not cleanly columnar". */
PyObject *extract_col_core(PyObject *seq, Py_ssize_t col, int from_entries) {
  Py_ssize_t n = PyList_GET_SIZE(seq);
  if (n == 0) return nullptr; /* empty: Python path decides */
  ColKind kind = K_UNSET;
  /* first pass: decide the dtype from the first cell, verify the rest */
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PyList_GET_ITEM(seq, i);
    if (from_entries && (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3))
      return nullptr;
    PyObject *row = from_entries ? PyTuple_GET_ITEM(item, 1) : item;
    if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) <= col) return nullptr;
    PyObject *v = PyTuple_GET_ITEM(row, col);
    PyTypeObject *t = Py_TYPE(v);
    ColKind k = t == &PyLong_Type    ? K_INT
                : t == &PyFloat_Type ? K_FLOAT
                : t == &PyBool_Type  ? K_BOOL
                                     : K_FAIL;
    if (k == K_FAIL) return nullptr;
    if (kind == K_UNSET)
      kind = k;
    else if (kind != k)
      return nullptr; /* mixed dtypes: exact semantics live row-wise */
  }
  npy_intp dims[1] = {n};
  int typenum = kind == K_INT ? NPY_INT64 : kind == K_FLOAT ? NPY_FLOAT64 : NPY_BOOL;
  PyObject *arr = PyArray_SimpleNew(1, dims, typenum);
  if (!arr) return nullptr; /* with error set */
  char *data = PyArray_BYTES((PyArrayObject *)arr);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PyList_GET_ITEM(seq, i);
    PyObject *row = from_entries ? PyTuple_GET_ITEM(item, 1) : item;
    PyObject *v = PyTuple_GET_ITEM(row, col);
    if (kind == K_INT) {
      int overflow = 0;
      long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
      if (overflow || (x == -1 && PyErr_Occurred())) {
        PyErr_Clear();
        Py_DECREF(arr);
        return nullptr; /* bigint: row path computes exact Python ints */
      }
      ((npy_int64 *)data)[i] = (npy_int64)x;
    } else if (kind == K_FLOAT) {
      ((npy_double *)data)[i] = PyFloat_AS_DOUBLE(v);
    } else {
      ((npy_bool *)data)[i] = (v == Py_True);
    }
  }
  return arr;
}

/* extract_column(seq, col, from_entries) -> ndarray | None
 * seq is a list of row tuples (from_entries=0) or (key,row,diff) entries
 * (from_entries=1). */
PyObject *extract_column(PyObject *, PyObject *args) {
  HIT(H_EXTRACT_COLUMN);
  PyObject *rows;
  Py_ssize_t col;
  int from_entries;
  if (!PyArg_ParseTuple(args, "O!np", &PyList_Type, &rows, &col, &from_entries))
    return nullptr;
  PyObject *arr = extract_col_core(rows, col, from_entries);
  if (!arr) {
    if (PyErr_Occurred()) return nullptr;
    Py_RETURN_NONE;
  }
  return arr;
}

/* entry_diffs(entries) -> int64 ndarray of each entry's diff. */
PyObject *entry_diffs(PyObject *, PyObject *args) {
  HIT(H_ENTRY_DIFFS);
  PyObject *entries;
  if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &entries)) return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(entries);
  npy_intp dims[1] = {n};
  PyObject *diffs = PyArray_SimpleNew(1, dims, NPY_INT64);
  if (!diffs) return nullptr;
  npy_int64 *ddata = (npy_int64 *)PyArray_BYTES((PyArrayObject *)diffs);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) != 3) {
      PyErr_SetString(PyExc_ValueError, "malformed entry");
      Py_DECREF(diffs);
      return nullptr;
    }
    long long d = PyLong_AsLongLong(PyTuple_GET_ITEM(e, 2));
    if (d == -1 && PyErr_Occurred()) {
      Py_DECREF(diffs);
      return nullptr;
    }
    ddata[i] = (npy_int64)d;
  }
  return diffs;
}

/* consolidate(entries) -> (new_entries | None, insert_only)
 *
 * None as first element means "already consolidated as-is" (the cheap
 * precheck passed); insert_only reports unique-key all-positive shape. */
PyObject *consolidate(PyObject *, PyObject *args) {
  HIT(H_CONSOLIDATE);
  PyObject *entries;
  if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &entries)) return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(entries);

  /* Precheck: all diffs > 0 and keys unique. */
  PyObject *seen = PySet_New(nullptr);
  if (!seen) return nullptr;
  bool clean = true;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) != 3) {
      clean = false;
      break;
    }
    PyObject *key = PyTuple_GET_ITEM(e, 0);
    PyObject *diff = PyTuple_GET_ITEM(e, 2);
    long d = PyLong_AsLong(diff);
    if (d == -1 && PyErr_Occurred()) {
      Py_DECREF(seen);
      return nullptr;
    }
    if (d <= 0) {
      clean = false;
      break;
    }
    int contains = PySet_Contains(seen, key);
    if (contains < 0) {
      Py_DECREF(seen);
      return nullptr;
    }
    if (contains) {
      clean = false;
      break;
    }
    if (PySet_Add(seen, key) < 0) {
      Py_DECREF(seen);
      return nullptr;
    }
  }
  Py_DECREF(seen);
  if (clean) {
    return Py_BuildValue("(OO)", Py_None, Py_True);
  }

  /* Full path: merge duplicate (key, row) entries preserving first-seen
   * order, drop zero diffs. acc maps (key, row) -> [row, diff] — the dict
   * resolves hash collisions by row equality; unhashable rows fall back to
   * identity. */
  PyObject *acc = PyDict_New();
  PyObject *order = PyList_New(0);
  if (!acc || !order) {
    Py_XDECREF(acc);
    Py_XDECREF(order);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    PyObject *key = PyTuple_GET_ITEM(e, 0);
    PyObject *row = PyTuple_GET_ITEM(e, 1);
    PyObject *diff = PyTuple_GET_ITEM(e, 2);
    Py_hash_t rh = PyObject_Hash(row);
    PyObject *slot;
    if (rh == -1) {
      PyErr_Clear(); /* unhashable row: fall back to identity */
      slot = Py_BuildValue("(On)", key, (Py_ssize_t)(uintptr_t)row);
    } else {
      slot = PyTuple_Pack(2, key, row);
    }
    if (!slot) goto fail;
    {
      PyObject *found = PyDict_GetItemWithError(acc, slot);
      if (!found && PyErr_Occurred()) {
        Py_DECREF(slot);
        goto fail;
      }
      if (!found) {
        PyObject *pair = PyList_New(2);
        if (!pair) {
          Py_DECREF(slot);
          goto fail;
        }
        Py_INCREF(row);
        PyList_SET_ITEM(pair, 0, row);
        Py_INCREF(diff);
        PyList_SET_ITEM(pair, 1, diff);
        if (PyDict_SetItem(acc, slot, pair) < 0) {
          Py_DECREF(pair);
          Py_DECREF(slot);
          goto fail;
        }
        Py_DECREF(pair);
        if (PyList_Append(order, slot) < 0) {
          Py_DECREF(slot);
          goto fail;
        }
      } else {
        PyObject *old = PyList_GET_ITEM(found, 1);
        PyObject *sum = PyNumber_Add(old, diff);
        if (!sum) {
          Py_DECREF(slot);
          goto fail;
        }
        PyList_SetItem(found, 1, sum); /* steals sum */
      }
      Py_DECREF(slot);
    }
  }
  {
    PyObject *out = PyList_New(0);
    if (!out) goto fail;
    Py_ssize_t m = PyList_GET_SIZE(order);
    for (Py_ssize_t i = 0; i < m; i++) {
      PyObject *slot = PyList_GET_ITEM(order, i);
      PyObject *pair = PyDict_GetItemWithError(acc, slot);
      if (!pair) {
        Py_DECREF(out);
        goto fail;
      }
      PyObject *row = PyList_GET_ITEM(pair, 0);
      PyObject *diff = PyList_GET_ITEM(pair, 1);
      long d = PyLong_AsLong(diff);
      if (d == -1 && PyErr_Occurred()) {
        Py_DECREF(out);
        goto fail;
      }
      if (d != 0) {
        PyObject *entry =
            PyTuple_Pack(3, PyTuple_GET_ITEM(slot, 0), row, diff);
        if (!entry || PyList_Append(out, entry) < 0) {
          Py_XDECREF(entry);
          Py_DECREF(out);
          goto fail;
        }
        Py_DECREF(entry);
      }
    }
    Py_DECREF(acc);
    Py_DECREF(order);
    PyObject *res = Py_BuildValue("(NO)", out, Py_False);
    return res;
  }
fail:
  Py_DECREF(acc);
  Py_DECREF(order);
  return nullptr;
}

/* apply_state(state_dict, entries, insert_only) -> None
 * Mirrors batch.apply_batch_to_state. */
PyObject *apply_state(PyObject *, PyObject *args) {
  HIT(H_APPLY_STATE);
  PyObject *state, *entries;
  int insert_only;
  if (!PyArg_ParseTuple(args, "O!O!p", &PyDict_Type, &state, &PyList_Type,
                        &entries, &insert_only))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(entries);
  if (insert_only) {
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject *e = PyList_GET_ITEM(entries, i);
      if (PyDict_SetItem(state, PyTuple_GET_ITEM(e, 0),
                         PyTuple_GET_ITEM(e, 1)) < 0)
        return nullptr;
    }
    Py_RETURN_NONE;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    long d = PyLong_AsLong(PyTuple_GET_ITEM(e, 2));
    if (d == -1 && PyErr_Occurred()) return nullptr;
    if (d < 0) {
      if (PyDict_DelItem(state, PyTuple_GET_ITEM(e, 0)) < 0) PyErr_Clear();
    }
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    long d = PyLong_AsLong(PyTuple_GET_ITEM(e, 2));
    if (d == -1 && PyErr_Occurred()) return nullptr;
    if (d > 0) {
      if (PyDict_SetItem(state, PyTuple_GET_ITEM(e, 0),
                         PyTuple_GET_ITEM(e, 1)) < 0)
        return nullptr;
    }
  }
  Py_RETURN_NONE;
}

/* build_entries(entries, columns) -> list
 * New entries with rows rebuilt from per-column Python lists (the tail of
 * the columnar expression path): row_i = (columns[0][i], columns[1][i],…),
 * keys/diffs reused from the input entries. */
PyObject *build_entries(PyObject *, PyObject *args) {
  HIT(H_BUILD_ENTRIES);
  PyObject *entries, *columns;
  if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &entries, &PyList_Type,
                        &columns))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(entries);
  Py_ssize_t ncols = PyList_GET_SIZE(columns);
  for (Py_ssize_t c = 0; c < ncols; c++) {
    PyObject *col = PyList_GET_ITEM(columns, c);
    if (!PyList_Check(col) || PyList_GET_SIZE(col) != n) {
      PyErr_SetString(PyExc_ValueError, "column length mismatch");
      return nullptr;
    }
  }
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    PyObject *row = PyTuple_New(ncols);
    if (!row) {
      Py_DECREF(out);
      return nullptr;
    }
    for (Py_ssize_t c = 0; c < ncols; c++) {
      PyObject *v = PyList_GET_ITEM(PyList_GET_ITEM(columns, c), i);
      Py_INCREF(v);
      PyTuple_SET_ITEM(row, c, v);
    }
    PyObject *entry =
        PyTuple_Pack(3, PyTuple_GET_ITEM(e, 0), row, PyTuple_GET_ITEM(e, 2));
    Py_DECREF(row);
    if (!entry) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, entry);
  }
  return out;
}

/* filter_truthy(entries, col) -> (list | None)
 * Keep entries whose row[col] is truthy. Returns None (for Python-side
 * fallback) if any condition value is not a plain bool — error poisoning
 * and odd truthiness keep their row-wise semantics. */
PyObject *filter_truthy(PyObject *, PyObject *args) {
  HIT(H_FILTER_TRUTHY);
  PyObject *entries;
  Py_ssize_t col;
  if (!PyArg_ParseTuple(args, "O!n", &PyList_Type, &entries, &col))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(entries);
  PyObject *out = PyList_New(0);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    PyObject *row = PyTuple_GET_ITEM(e, 1);
    if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) <= col) {
      Py_DECREF(out);
      Py_RETURN_NONE;
    }
    PyObject *v = PyTuple_GET_ITEM(row, col);
    if (v == Py_True) {
      if (PyList_Append(out, e) < 0) {
        Py_DECREF(out);
        return nullptr;
      }
    } else if (v != Py_False) {
      Py_DECREF(out);
      Py_RETURN_NONE; /* non-bool condition: row-wise semantics */
    }
  }
  return out;
}

/* -- blake2b (RFC 7693) for join result keys ---------------------------------
 *
 * Digest-identical to engine/value.py hash_values: digest_size=16,
 * personal "pw-tpu-key", message = salt + per-value tagged bytes. Only the
 * Pointer-pair message shape is produced here (join_result_key), so the
 * implementation is the compact single-purpose core, not a general hash
 * library.
 */

const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

void b2b_compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
                  int last) {
  uint64_t v[16], m[16];
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
  v[12] ^= t; /* low counter word; messages here are far below 2^64 */
  if (last) v[14] = ~v[14];
  memcpy(m, block, 128); /* little-endian host assumed (x86/arm64) */
  for (int r = 0; r < 12; r++) {
    const uint8_t *s = B2B_SIGMA[r];
#define B2B_G(a, b, c, d, x, y)                 \
  v[a] = v[a] + v[b] + (x);                     \
  v[d] = rotr64(v[d] ^ v[a], 32);               \
  v[c] = v[c] + v[d];                           \
  v[b] = rotr64(v[b] ^ v[c], 24);               \
  v[a] = v[a] + v[b] + (y);                     \
  v[d] = rotr64(v[d] ^ v[a], 16);               \
  v[c] = v[c] + v[d];                           \
  v[b] = rotr64(v[b] ^ v[c], 63);
    B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
#undef B2B_G
  }
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

/* blake2b-128 of a short (<=128 byte) message with personal "pw-tpu-key". */
void b2b16_short(const uint8_t *msg, size_t len, uint8_t out[16]) {
  uint64_t h[8];
  for (int i = 0; i < 8; i++) h[i] = B2B_IV[i];
  /* param block: digest_length=16, fanout=1, depth=1, personal @48 */
  uint8_t param[64] = {0};
  param[0] = 16;
  param[2] = 1;
  param[3] = 1;
  memcpy(param + 48, "pw-tpu-key", 10);
  uint64_t pw[8];
  memcpy(pw, param, 64);
  for (int i = 0; i < 8; i++) h[i] ^= pw[i];
  uint8_t block[128] = {0};
  memcpy(block, msg, len);
  b2b_compress(h, block, (uint64_t)len, 1);
  memcpy(out, h, 16);
}

/* -- insert-only inner-join delta --------------------------------------------
 *
 * The C floor under JoinNode._process_insert_only_inner (engine/graph.py):
 * ΔR pairs against the pre-delta left arrangement, then ΔL against the
 * post-delta right arrangement. Join keys limited to scalar types the
 * Python _jk would hash unchanged (int/bool/float/str/bytes incl.
 * subclasses like Pointer); anything else — or an ERROR cell — bails to
 * the Python path BEFORE mutating either arrangement.
 */

int jk_value_ok(PyObject *v, PyObject *error_obj) {
  if (v == error_obj) return 0;
  return PyLong_Check(v) || PyFloat_Check(v) || PyUnicode_Check(v) ||
         PyBytes_Check(v);
}

/* row key (Pointer int) -> 16 little-endian bytes; -1 on failure */
int key_bytes(PyObject *key, uint8_t out[16]) {
  if (!PyLong_Check(key)) return -1;
#if PY_VERSION_HEX >= 0x030d0000
  if (PyLong_AsNativeBytes(key, out, 16,
                           Py_ASNATIVEBYTES_LITTLE_ENDIAN |
                               Py_ASNATIVEBYTES_UNSIGNED_BUFFER) < 0)
    return -1;
#else
  if (_PyLong_AsByteArray((PyLongObject *)key, out, 16, 1, 0) < 0) return -1;
#endif
  return 0;
}

/* blake2b16("join" + 0x04 lkey16 + 0x04 rkey16) -> new Pointer.
 * Pointer construction goes through int.__new__ (PyLong_Type.tp_new)
 * directly: the digest is 128 bits by construction, so the Python-level
 * Pointer.__new__ masking wrapper adds nothing but a frame per pair
 * (measured >50% of the join kernel's time). */
PyObject *join_pair_key(PyObject *pointer_type, const uint8_t lk[16],
                        const uint8_t rk[16]) {
  uint8_t msg[4 + 17 + 17];
  memcpy(msg, "join", 4);
  msg[4] = 0x04; /* _H_POINTER */
  memcpy(msg + 5, lk, 16);
  msg[21] = 0x04;
  memcpy(msg + 22, rk, 16);
  uint8_t digest[16];
  b2b16_short(msg, sizeof(msg), digest);
  PyObject *as_int = _PyLong_FromByteArray(digest, 16, 1, 0);
  if (!as_int) return nullptr;
  /* thread-safe without locking: the GIL is held throughout */
  static PyObject *argtuple = nullptr;
  if (!argtuple || Py_REFCNT(argtuple) != 1) {
    argtuple = PyTuple_New(1);
    if (!argtuple) {
      Py_DECREF(as_int);
      return nullptr;
    }
  } else {
    Py_XDECREF(PyTuple_GET_ITEM(argtuple, 0));
  }
  PyTuple_SET_ITEM(argtuple, 0, as_int);
  PyObject *ptr =
      PyLong_Type.tp_new((PyTypeObject *)pointer_type, argtuple, nullptr);
  return ptr;
}

/* build the join-key tuple for one row; NULL with no error set = bail */
PyObject *make_jk(PyObject *row, PyObject *cols, PyObject *error_obj) {
  Py_ssize_t k = PyList_GET_SIZE(cols);
  PyObject *jk = PyTuple_New(k);
  if (!jk) return nullptr;
  for (Py_ssize_t c = 0; c < k; c++) {
    Py_ssize_t idx = PyLong_AsSsize_t(PyList_GET_ITEM(cols, c));
    if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) <= idx) {
      Py_DECREF(jk);
      return nullptr;
    }
    PyObject *v = PyTuple_GET_ITEM(row, idx);
    if (!jk_value_ok(v, error_obj)) {
      Py_DECREF(jk);
      return nullptr;
    }
    Py_INCREF(v);
    PyTuple_SET_ITEM(jk, c, v);
  }
  return jk;
}

/* pair every arranged row of `group` with (key,row); append to out and
 * mirror into `current` (the node state) */
int emit_pairs(PyObject *out, PyObject *group, PyObject *key, PyObject *row,
               int row_is_left, PyObject *pointer_type, PyObject *one,
               PyObject *current, PyObject *jrk_fn) {
  uint8_t kb[16];
  if (key_bytes(key, kb) < 0) return -1;
  PyObject *gk, *grow;
  Py_ssize_t pos = 0;
  while (PyDict_Next(group, &pos, &gk, &grow)) {
    PyObject *okey;
    if ((PyObject *)Py_TYPE(gk) == pointer_type) {
      uint8_t gb[16];
      if (key_bytes(gk, gb) < 0) return -1;
      okey = row_is_left ? join_pair_key(pointer_type, kb, gb)
                         : join_pair_key(pointer_type, gb, kb);
    } else {
      /* arrangement rows from an earlier bailed (Python-path) batch may
       * carry non-Pointer keys; route those pairs through the Python
       * join_result_key so both paths agree on result identity */
      okey = row_is_left
                 ? PyObject_CallFunctionObjArgs(jrk_fn, key, gk, nullptr)
                 : PyObject_CallFunctionObjArgs(jrk_fn, gk, key, nullptr);
    }
    if (!okey) return -1;
    PyObject *orow = row_is_left ? PySequence_Concat(row, grow)
                                 : PySequence_Concat(grow, row);
    if (!orow) {
      Py_DECREF(okey);
      return -1;
    }
    PyObject *entry = PyTuple_Pack(3, okey, orow, one);
    int rc = entry ? PyList_Append(out, entry) : -1;
    Py_XDECREF(entry);
    /* current == None: caller defers state application (lazy node state) */
    if (rc == 0 && current != Py_None)
      rc = PyDict_SetItem(current, okey, orow);
    Py_DECREF(okey);
    Py_DECREF(orow);
    if (rc < 0) return -1;
  }
  return 0;
}

/* one side of the delta: pair each entry against `probe_arr`, then insert
 * it into `build_arr`. Returns 0 ok, -1 error (error set). */
int join_side(PyObject *entries, PyObject *cols, PyObject *probe_arr,
              PyObject *build_arr, PyObject *out, int is_left,
              PyObject *error_obj, PyObject *pointer_type, PyObject *one,
              PyObject *current, PyObject *jrk_fn) {
  Py_ssize_t n = PyList_GET_SIZE(entries);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    PyObject *key = PyTuple_GET_ITEM(e, 0);
    PyObject *row = PyTuple_GET_ITEM(e, 1);
    PyObject *jk = make_jk(row, cols, error_obj);
    if (!jk) return -1; /* prescan guarantees this cannot happen */
    PyObject *group = PyDict_GetItem(probe_arr, jk);
    if (group && PyDict_Check(group) &&
        emit_pairs(out, group, key, row, is_left, pointer_type, one,
                   current, jrk_fn) < 0) {
      Py_DECREF(jk);
      return -1;
    }
    PyObject *build_group = PyDict_GetItem(build_arr, jk);
    if (!build_group) {
      build_group = PyDict_New();
      if (!build_group || PyDict_SetItem(build_arr, jk, build_group) < 0) {
        Py_XDECREF(build_group);
        Py_DECREF(jk);
        return -1;
      }
      Py_DECREF(build_group); /* arr holds it */
    }
    if (PyDict_SetItem(build_group, key, row) < 0) {
      Py_DECREF(jk);
      return -1;
    }
    Py_DECREF(jk);
  }
  return 0;
}

/* every entry well-formed, keys EXACTLY Pointer, jk cells scalar
 * non-ERROR? Exact-Pointer matters: join_pair_key tags keys _H_POINTER
 * unsigned-16LE, which only matches Python's hash_values for genuine
 * Pointers — a plain (possibly negative) int key must bail to Python so
 * the fast and general paths derive identical result keys. */
int join_prescan(PyObject *entries, PyObject *cols, PyObject *error_obj,
                 PyObject *pointer_type) {
  Py_ssize_t n = PyList_GET_SIZE(entries);
  Py_ssize_t k = PyList_GET_SIZE(cols);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) != 3) return 0;
    if ((PyObject *)Py_TYPE(PyTuple_GET_ITEM(e, 0)) != pointer_type)
      return 0;
    /* diff must be exactly 1: insert-only batches may legally carry
     * multiplicities > 1, which this pair-emitting kernel (and the dict
     * arrangements, which drop multiplicity) cannot represent */
    PyObject *diff = PyTuple_GET_ITEM(e, 2);
    if (!PyLong_Check(diff) || PyLong_AsLong(diff) != 1) return 0;
    PyObject *row = PyTuple_GET_ITEM(e, 1);
    if (!PyTuple_Check(row)) return 0;
    for (Py_ssize_t c = 0; c < k; c++) {
      Py_ssize_t idx = PyLong_AsSsize_t(PyList_GET_ITEM(cols, c));
      if (idx < 0 || PyTuple_GET_SIZE(row) <= idx) return 0;
      if (!jk_value_ok(PyTuple_GET_ITEM(row, idx), error_obj)) return 0;
    }
  }
  return 1;
}

/* join_insert_inner(left_entries, right_entries, left_on, right_on,
 *                   left_arr, right_arr, error_obj, pointer_type, current)
 *   -> entries list | None (bail to Python; arrangements untouched).
 * `current` (the node's key->row state) is written alongside emission, so
 * the scheduler's apply_batch_to_state pass is skipped (_preapplied). */
PyObject *join_insert_inner(PyObject *, PyObject *args) {
  HIT(H_JOIN_INSERT_INNER);
  PyObject *le, *re, *lon, *ron, *larr, *rarr, *error_obj, *pointer_type,
      *current, *jrk_fn;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!OOOO", &PyList_Type, &le,
                        &PyList_Type, &re, &PyList_Type, &lon, &PyList_Type,
                        &ron, &PyDict_Type, &larr, &PyDict_Type, &rarr,
                        &error_obj, &pointer_type, &current, &jrk_fn))
    return nullptr;
  if (current != Py_None && !PyDict_Check(current)) {
    PyErr_SetString(PyExc_TypeError, "current must be a dict or None");
    return nullptr;
  }
  if (!PyType_Check(pointer_type) ||
      !PyType_IsSubtype((PyTypeObject *)pointer_type, &PyLong_Type))
    Py_RETURN_NONE; /* tp_new shortcut requires an int subclass */
  if (!join_prescan(le, lon, error_obj, pointer_type) ||
      !join_prescan(re, ron, error_obj, pointer_type))
    Py_RETURN_NONE;
  PyObject *out = PyList_New(0);
  if (!out) return nullptr;
  PyObject *one = PyLong_FromLong(1);
  /* ΔR probes the pre-delta left arrangement and lands in right_arr... */
  if (join_side(re, ron, larr, rarr, out, 0, error_obj, pointer_type, one,
                current, jrk_fn) < 0 ||
      /* ...then ΔL probes the post-delta right arrangement */
      join_side(le, lon, rarr, larr, out, 1, error_obj, pointer_type, one,
                current, jrk_fn) < 0) {
    Py_DECREF(out);
    Py_DECREF(one);
    return nullptr;
  }
  Py_DECREF(one);
  return out;
}

/* -- columnar key plumbing ---------------------------------------------------
 *
 * The columnar DeltaBatch (engine/batch.py Columns) stores keys as a
 * (n,16) little-endian byte matrix; these kernels convert to/from the
 * Pointer-object view and derive join result keys vectorized — one C
 * pass instead of per-row hashlib + int.to_bytes.
 */

/* make a Pointer (int subclass) from 16 LE bytes via tp_new, skipping the
 * Python-level __new__ masking wrapper (the digest is already 128-bit) */
PyObject *pointer_from_bytes(PyTypeObject *pointer_type,
                             const uint8_t b[16]) {
  PyObject *as_int = _PyLong_FromByteArray(b, 16, 1, 0);
  if (!as_int) return nullptr;
  PyObject *argtuple = PyTuple_New(1);
  if (!argtuple) {
    Py_DECREF(as_int);
    return nullptr;
  }
  PyTuple_SET_ITEM(argtuple, 0, as_int);
  PyObject *ptr = PyLong_Type.tp_new(pointer_type, argtuple, nullptr);
  Py_DECREF(argtuple);
  return ptr;
}

/* pointers_to_bytes(keys_list) -> (n,16) uint8 ndarray | None (non-int) */
PyObject *pointers_to_bytes(PyObject *, PyObject *args) {
  HIT(H_POINTERS_TO_BYTES);
  PyObject *keys;
  if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &keys)) return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(keys);
  npy_intp dims[2] = {n, 16};
  PyObject *arr = PyArray_SimpleNew(2, dims, NPY_UINT8);
  if (!arr) return nullptr;
  uint8_t *data = (uint8_t *)PyArray_BYTES((PyArrayObject *)arr);
  for (Py_ssize_t i = 0; i < n; i++) {
    if (key_bytes(PyList_GET_ITEM(keys, i), data + i * 16) < 0) {
      Py_DECREF(arr);
      if (!PyErr_Occurred()) Py_RETURN_NONE;
      return nullptr;
    }
  }
  return arr;
}

/* bytes_to_pointers(arr, pointer_type) -> list of Pointer */
PyObject *bytes_to_pointers(PyObject *, PyObject *args) {
  HIT(H_BYTES_TO_POINTERS);
  PyObject *arr_obj, *pointer_type;
  if (!PyArg_ParseTuple(args, "O!O", &PyArray_Type, &arr_obj, &pointer_type))
    return nullptr;
  if (!PyType_Check(pointer_type) ||
      !PyType_IsSubtype((PyTypeObject *)pointer_type, &PyLong_Type)) {
    PyErr_SetString(PyExc_TypeError, "pointer_type must subclass int");
    return nullptr;
  }
  PyArrayObject *arr = (PyArrayObject *)arr_obj;
  if (PyArray_NDIM(arr) != 2 || PyArray_DIM(arr, 1) != 16 ||
      PyArray_TYPE(arr) != NPY_UINT8 ||
      !PyArray_IS_C_CONTIGUOUS(arr)) {
    PyErr_SetString(PyExc_ValueError, "expected C-contiguous (n,16) uint8");
    return nullptr;
  }
  Py_ssize_t n = PyArray_DIM(arr, 0);
  const uint8_t *data = (const uint8_t *)PyArray_BYTES(arr);
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *p = pointer_from_bytes((PyTypeObject *)pointer_type,
                                     data + i * 16);
    if (!p) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, p);
  }
  return out;
}

/* entry_keys_bytes(entries, pointer_type) -> (n,16) uint8 | None.
 * None when any key is not EXACTLY a Pointer (subclass tagging matters:
 * hash_join_pairs tags _H_POINTER, which only matches hash_values for
 * genuine Pointers). */
PyObject *entry_keys_bytes(PyObject *, PyObject *args) {
  HIT(H_ENTRY_KEYS_BYTES);
  PyObject *entries, *pointer_type;
  if (!PyArg_ParseTuple(args, "O!O", &PyList_Type, &entries, &pointer_type))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(entries);
  npy_intp dims[2] = {n, 16};
  PyObject *arr = PyArray_SimpleNew(2, dims, NPY_UINT8);
  if (!arr) return nullptr;
  uint8_t *data = (uint8_t *)PyArray_BYTES((PyArrayObject *)arr);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) != 3) {
      Py_DECREF(arr);
      Py_RETURN_NONE;
    }
    PyObject *key = PyTuple_GET_ITEM(e, 0);
    if ((PyObject *)Py_TYPE(key) != pointer_type ||
        key_bytes(key, data + i * 16) < 0) {
      Py_DECREF(arr);
      if (PyErr_Occurred()) return nullptr;
      Py_RETURN_NONE;
    }
  }
  return arr;
}

/* hash_join_pairs(lbytes, rbytes) -> (n,16) uint8 of
 * blake2b16("join" + 0x04 lk + 0x04 rk) — vectorized join_result_key. */
PyObject *hash_join_pairs(PyObject *, PyObject *args) {
  HIT(H_HASH_JOIN_PAIRS);
  PyObject *l_obj, *r_obj;
  if (!PyArg_ParseTuple(args, "O!O!", &PyArray_Type, &l_obj, &PyArray_Type,
                        &r_obj))
    return nullptr;
  PyArrayObject *l = (PyArrayObject *)l_obj, *r = (PyArrayObject *)r_obj;
  PyArrayObject *pair[2] = {l, r};
  for (int side = 0; side < 2; side++) {
    PyArrayObject *a = pair[side];
    if (PyArray_NDIM(a) != 2 || PyArray_DIM(a, 1) != 16 ||
        PyArray_TYPE(a) != NPY_UINT8 || !PyArray_IS_C_CONTIGUOUS(a)) {
      PyErr_SetString(PyExc_ValueError,
                      "expected C-contiguous (n,16) uint8");
      return nullptr;
    }
  }
  if (PyArray_DIM(l, 0) != PyArray_DIM(r, 0)) {
    PyErr_SetString(PyExc_ValueError, "length mismatch");
    return nullptr;
  }
  Py_ssize_t n = PyArray_DIM(l, 0);
  npy_intp dims[2] = {n, 16};
  PyObject *out = PyArray_SimpleNew(2, dims, NPY_UINT8);
  if (!out) return nullptr;
  const uint8_t *lb = (const uint8_t *)PyArray_BYTES(l);
  const uint8_t *rb = (const uint8_t *)PyArray_BYTES(r);
  uint8_t *ob = (uint8_t *)PyArray_BYTES((PyArrayObject *)out);
  uint8_t msg[4 + 17 + 17];
  memcpy(msg, "join", 4);
  msg[4] = 0x04; /* _H_POINTER */
  msg[21] = 0x04;
  for (Py_ssize_t i = 0; i < n; i++) {
    memcpy(msg + 5, lb + i * 16, 16);
    memcpy(msg + 22, rb + i * 16, 16);
    b2b16_short(msg, sizeof(msg), ob + i * 16);
  }
  return out;
}

/* one cell of a 1-D column array -> new reference */
PyObject *cell_to_object(PyArrayObject *col, Py_ssize_t i) {
  switch (PyArray_TYPE(col)) {
    case NPY_INT64:
      return PyLong_FromLongLong(*(npy_int64 *)PyArray_GETPTR1(col, i));
    case NPY_FLOAT64:
      return PyFloat_FromDouble(*(npy_double *)PyArray_GETPTR1(col, i));
    case NPY_BOOL: {
      PyObject *v = *(npy_bool *)PyArray_GETPTR1(col, i) ? Py_True : Py_False;
      Py_INCREF(v);
      return v;
    }
    case NPY_OBJECT: {
      PyObject *v = *(PyObject **)PyArray_GETPTR1(col, i);
      Py_INCREF(v);
      return v;
    }
    default:
      /* strings / datetimes / anything else: generic numpy conversion */
      return PyArray_GETITEM(col, (const char *)PyArray_GETPTR1(col, i));
  }
}

/* columns_to_entries(keys_list, cols_list, diffs|None) -> entries list.
 * cols_list: 1-D ndarrays, one per column; diffs: int64 ndarray or None. */
PyObject *columns_to_entries(PyObject *, PyObject *args) {
  HIT(H_COLUMNS_TO_ENTRIES);
  PyObject *keys, *cols, *diffs_obj;
  if (!PyArg_ParseTuple(args, "O!O!O", &PyList_Type, &keys, &PyList_Type,
                        &cols, &diffs_obj))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(keys);
  Py_ssize_t arity = PyList_GET_SIZE(cols);
  const npy_int64 *diffs = nullptr;
  if (diffs_obj != Py_None) {
    if (!PyArray_Check(diffs_obj) ||
        PyArray_TYPE((PyArrayObject *)diffs_obj) != NPY_INT64 ||
        PyArray_NDIM((PyArrayObject *)diffs_obj) != 1 ||
        PyArray_DIM((PyArrayObject *)diffs_obj, 0) != n ||
        !PyArray_IS_C_CONTIGUOUS((PyArrayObject *)diffs_obj)) {
      PyErr_SetString(PyExc_ValueError, "diffs must be contiguous int64[n]");
      return nullptr;
    }
    diffs = (const npy_int64 *)PyArray_BYTES((PyArrayObject *)diffs_obj);
  }
  for (Py_ssize_t c = 0; c < arity; c++) {
    PyObject *col = PyList_GET_ITEM(cols, c);
    if (!PyArray_Check(col) || PyArray_NDIM((PyArrayObject *)col) != 1 ||
        PyArray_DIM((PyArrayObject *)col, 0) != n) {
      PyErr_SetString(PyExc_ValueError, "columns must be 1-D ndarrays[n]");
      return nullptr;
    }
  }
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  PyObject *one = PyLong_FromLong(1);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *row = PyTuple_New(arity);
    if (!row) goto fail;
    for (Py_ssize_t c = 0; c < arity; c++) {
      PyObject *v =
          cell_to_object((PyArrayObject *)PyList_GET_ITEM(cols, c), i);
      if (!v) {
        Py_DECREF(row);
        goto fail;
      }
      PyTuple_SET_ITEM(row, c, v);
    }
    PyObject *diff;
    if (diffs) {
      diff = PyLong_FromLongLong(diffs[i]);
      if (!diff) {
        Py_DECREF(row);
        goto fail;
      }
    } else {
      diff = one;
      Py_INCREF(one);
    }
    PyObject *key = PyList_GET_ITEM(keys, i);
    Py_INCREF(key);
    PyObject *entry = PyTuple_New(3);
    if (!entry) {
      Py_DECREF(row);
      Py_DECREF(diff);
      Py_DECREF(key);
      goto fail;
    }
    PyTuple_SET_ITEM(entry, 0, key);
    PyTuple_SET_ITEM(entry, 1, row);
    PyTuple_SET_ITEM(entry, 2, diff);
    PyList_SET_ITEM(out, i, entry);
  }
  Py_DECREF(one);
  return out;
fail:
  Py_DECREF(one);
  Py_DECREF(out);
  return nullptr;
}

/* -- gen-2 kernels: batched digests, shard coding, side extraction -----------
 *
 * Everything below is digest- or result-identical to a pure-Python
 * implementation that stays in the tree (engine/value.py `_digest16`/
 * `_feed`, engine/routing.py `_shard_of`, graph.py `_side_from_batch` /
 * `_match_join_pairs_multi`, `InputSession.flush`): the kernels bail —
 * Py_RETURN_NONE, or a per-item Python fallback callable — the moment a
 * value leaves the exact-type fast set, so the Python path remains THE
 * definition of behavior and the property suite can assert bit equality.
 */

/* Streaming blake2b-128 (digest_size=16, personal "pw-tpu-key"): the
 * b2b16_short core above only handles <=128-byte messages; value tuples
 * (strings, nested tuples) need the full chunked update loop. */
struct B2BCtx {
  uint64_t h[8];
  uint64_t t;       /* bytes fed into compress so far (incl. current) */
  size_t buflen;
  uint8_t buf[128];
};

void b2b_init(B2BCtx *c) {
  for (int i = 0; i < 8; i++) c->h[i] = B2B_IV[i];
  uint8_t param[64] = {0};
  param[0] = 16;
  param[2] = 1;
  param[3] = 1;
  memcpy(param + 48, "pw-tpu-key", 10);
  uint64_t pw[8];
  memcpy(pw, param, 64);
  for (int i = 0; i < 8; i++) c->h[i] ^= pw[i];
  c->t = 0;
  c->buflen = 0;
}

void b2b_update(B2BCtx *c, const uint8_t *data, size_t len) {
  while (len > 0) {
    if (c->buflen == 128) {
      /* flush a full buffer only when more input follows — the final
       * block must go through b2b_final with the last flag set */
      c->t += 128;
      b2b_compress(c->h, c->buf, c->t, 0);
      c->buflen = 0;
    }
    size_t take = 128 - c->buflen;
    if (take > len) take = len;
    memcpy(c->buf + c->buflen, data, take);
    c->buflen += take;
    data += take;
    len -= take;
  }
}

void b2b_final(B2BCtx *c, uint8_t out[16]) {
  c->t += c->buflen;
  memset(c->buf + c->buflen, 0, 128 - c->buflen);
  b2b_compress(c->h, c->buf, c->t, 1);
  memcpy(out, c->h, 16);
}

/* arbitrary PyLong -> 16-byte signed little-endian, matching
 * int.to_bytes(16, "little", signed=True) including the OverflowError. */
int long_to_signed16(PyObject *v, uint8_t out[16]) {
  int overflow = 0;
  long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (!overflow) {
    if (x == -1 && PyErr_Occurred()) return -1;
    memcpy(out, &x, 8);
    memset(out + 8, x < 0 ? 0xff : 0x00, 8);
    return 0;
  }
#if PY_VERSION_HEX >= 0x030d0000
  Py_ssize_t r = PyLong_AsNativeBytes(v, out, 16,
                                      Py_ASNATIVEBYTES_LITTLE_ENDIAN);
  if (r < 0) return -1;
  if (r > 16) {
    PyErr_SetString(PyExc_OverflowError, "int too big to convert");
    return -1;
  }
  return 0;
#else
  return _PyLong_AsByteArray((PyLongObject *)v, out, 16, 1, 1);
#endif
}

/* Feed one value's tagged serialization (engine/value.py `_feed` /
 * `_digest16` byte stream) into the hash context.
 * Returns 0 = fed, 1 = bail to the Python fallback (type outside the
 * exact fast set), -1 = Python error set (propagates, matching the
 * exception the Python path would raise: OverflowError on >128-bit
 * ints, UnicodeEncodeError on surrogates). */
int feed_value(B2BCtx *c, PyObject *v, PyObject *pointer_type,
               PyObject *error_obj, int depth) {
  if (depth > 32) return 1; /* pathological nesting: Python recursion rules */
  PyTypeObject *t = Py_TYPE(v);
  if ((PyObject *)t == pointer_type) {
    uint8_t b[17];
    b[0] = 0x04; /* _H_POINTER */
    if (key_bytes(v, b + 1) < 0) return -1;
    b2b_update(c, b, 17);
    return 0;
  }
  if (v == Py_None) {
    uint8_t b = 0x00; /* _H_NONE */
    b2b_update(c, &b, 1);
    return 0;
  }
  if (v == error_obj) {
    uint8_t b = 0x0d; /* _H_ERROR */
    b2b_update(c, &b, 1);
    return 0;
  }
  if (t == &PyBool_Type) {
    uint8_t b[2] = {0x01, (uint8_t)(v == Py_True ? 1 : 0)};
    b2b_update(c, b, 2);
    return 0;
  }
  if (t == &PyLong_Type) {
    uint8_t b[17];
    b[0] = 0x02; /* _H_INT */
    if (long_to_signed16(v, b + 1) < 0) return -1;
    b2b_update(c, b, 17);
    return 0;
  }
  if (t == &PyFloat_Type) {
    double f = PyFloat_AS_DOUBLE(v);
    uint8_t b[17];
    if (f == f && !std::isinf(f) && std::fabs(f) < 9223372036854775808.0 &&
        std::trunc(f) == f) {
      /* integral in-range floats hash as ints (engine equality) */
      b[0] = 0x02;
      long long x = (long long)f;
      memcpy(b + 1, &x, 8);
      memset(b + 9, x < 0 ? 0xff : 0x00, 8);
      b2b_update(c, b, 17);
    } else {
      b[0] = 0x03; /* _H_FLOAT */
      memcpy(b + 1, &f, 8);
      b2b_update(c, b, 9);
    }
    return 0;
  }
  if (t == &PyUnicode_Type) {
    Py_ssize_t len;
    const char *s = PyUnicode_AsUTF8AndSize(v, &len);
    if (!s) return -1;
    uint8_t hdr[9];
    hdr[0] = 0x05; /* _H_STRING */
    uint64_t l = (uint64_t)len;
    memcpy(hdr + 1, &l, 8);
    b2b_update(c, hdr, 9);
    b2b_update(c, (const uint8_t *)s, (size_t)len);
    return 0;
  }
  if (t == &PyBytes_Type) {
    uint8_t hdr[9];
    hdr[0] = 0x06; /* _H_BYTES */
    uint64_t l = (uint64_t)PyBytes_GET_SIZE(v);
    memcpy(hdr + 1, &l, 8);
    b2b_update(c, hdr, 9);
    b2b_update(c, (const uint8_t *)PyBytes_AS_STRING(v), (size_t)l);
    return 0;
  }
  if (t == &PyTuple_Type || t == &PyList_Type) {
    int is_tuple = t == &PyTuple_Type;
    Py_ssize_t sz = is_tuple ? PyTuple_GET_SIZE(v) : PyList_GET_SIZE(v);
    uint8_t hdr[9];
    hdr[0] = 0x07; /* _H_TUPLE */
    uint64_t l = (uint64_t)sz;
    memcpy(hdr + 1, &l, 8);
    b2b_update(c, hdr, 9);
    for (Py_ssize_t i = 0; i < sz; i++) {
      PyObject *item =
          is_tuple ? PyTuple_GET_ITEM(v, i) : PyList_GET_ITEM(v, i);
      int rc = feed_value(c, item, pointer_type, error_obj, depth + 1);
      if (rc != 0) return rc;
    }
    return 0;
  }
  /* ndarray / datetime / Json / wrapper / np scalars / subclasses:
   * the Python serializer owns these */
  return 1;
}

/* call the per-item Python fallback; must return exactly 16 bytes */
int fallback_digest(PyObject *fallback, PyObject *item, uint8_t out[16]) {
  PyObject *d = PyObject_CallFunctionObjArgs(fallback, item, nullptr);
  if (!d) return -1;
  if (!PyBytes_Check(d) || PyBytes_GET_SIZE(d) != 16) {
    Py_DECREF(d);
    PyErr_SetString(PyExc_ValueError, "fallback must return 16 bytes");
    return -1;
  }
  memcpy(out, PyBytes_AS_STRING(d), 16);
  Py_DECREF(d);
  return 0;
}

/* hash_tuples_batch(rows, salt, bare, Pointer, ERROR, fallback)
 *   -> (n,16) uint8 digest matrix.
 * rows: list (or 1-D object ndarray) of value tuples — or of bare values
 * when bare is true (the object-column coding path hands the column array
 * straight in; no [(v,) for v in col.tolist()] materialization).
 * fallback(item) -> bytes16 computes any row the native serializer
 * cannot, carrying the caller's on_type_error semantics. */
PyObject *hash_tuples_batch(PyObject *, PyObject *args) {
  HIT(H_HASH_TUPLES_BATCH);
  PyObject *rows, *salt_obj, *pointer_type, *error_obj, *fallback;
  int bare;
  if (!PyArg_ParseTuple(args, "OO!pOOO", &rows, &PyBytes_Type, &salt_obj,
                        &bare, &pointer_type, &error_obj, &fallback))
    return nullptr;
  Py_ssize_t n;
  int is_list = PyList_Check(rows);
  PyObject **items = nullptr;
  if (is_list) {
    n = PyList_GET_SIZE(rows);
  } else if (PyArray_Check(rows)) {
    PyArrayObject *a = (PyArrayObject *)rows;
    if (PyArray_TYPE(a) != NPY_OBJECT || PyArray_NDIM(a) != 1 ||
        !PyArray_IS_C_CONTIGUOUS(a)) {
      PyErr_SetString(PyExc_ValueError,
                      "rows must be a list or contiguous 1-D object array");
      return nullptr;
    }
    n = PyArray_DIM(a, 0);
    items = (PyObject **)PyArray_BYTES(a);
  } else {
    PyErr_SetString(PyExc_TypeError, "rows must be a list or object ndarray");
    return nullptr;
  }
  const uint8_t *salt = (const uint8_t *)PyBytes_AS_STRING(salt_obj);
  size_t saltlen = (size_t)PyBytes_GET_SIZE(salt_obj);
  npy_intp dims[2] = {n, 16};
  PyObject *out = PyArray_SimpleNew(2, dims, NPY_UINT8);
  if (!out) return nullptr;
  uint8_t *ob = (uint8_t *)PyArray_BYTES((PyArrayObject *)out);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *row = is_list ? PyList_GET_ITEM(rows, i) : items[i];
    B2BCtx c;
    b2b_init(&c);
    if (saltlen) b2b_update(&c, salt, saltlen);
    int rc = 0;
    if (bare) {
      rc = feed_value(&c, row, pointer_type, error_obj, 0);
    } else if (PyTuple_CheckExact(row) || PyList_CheckExact(row)) {
      int is_tuple = PyTuple_CheckExact(row);
      Py_ssize_t sz =
          is_tuple ? PyTuple_GET_SIZE(row) : PyList_GET_SIZE(row);
      for (Py_ssize_t j = 0; j < sz; j++) {
        PyObject *v =
            is_tuple ? PyTuple_GET_ITEM(row, j) : PyList_GET_ITEM(row, j);
        rc = feed_value(&c, v, pointer_type, error_obj, 0);
        if (rc != 0) break;
      }
    } else {
      rc = 1; /* exotic row container: fallback iterates it */
    }
    if (rc < 0) {
      Py_DECREF(out);
      return nullptr;
    }
    if (rc == 1) {
      if (fallback_digest(fallback, row, ob + i * 16) < 0) {
        Py_DECREF(out);
        return nullptr;
      }
    } else {
      b2b_final(&c, ob + i * 16);
    }
  }
  return out;
}

/* 16 little-endian bytes (u128) mod n — identical to Python int % n for
 * the non-negative 128-bit keys/digests this is applied to. */
inline int64_t mod_u128(const uint8_t b[16], uint64_t n) {
  unsigned __int128 x;
  memcpy(&x, b, 16); /* little-endian host assumed, as in b2b_compress */
  return (int64_t)(x % n);
}

/* shard_values(values, salt, n, Pointer, ERROR, fallback)
 *   -> int64[n] worker ids | None (whole-call bail).
 * The batched routing._shard_of: exact Pointers take int(v) % n on their
 * key bytes; everything else digests (salt + value) and folds mod n;
 * values the native serializer cannot feed go through fallback(v) ->
 * bytes16 (which carries the TypeError->repr rule). Pointer SUBCLASSES
 * bail the whole call — isinstance semantics route them to int(v) % n,
 * which only the Python path does safely for arbitrary ints. */
PyObject *shard_values(PyObject *, PyObject *args) {
  HIT(H_SHARD_VALUES);
  PyObject *values, *salt_obj, *pointer_type, *error_obj, *fallback;
  Py_ssize_t nshards;
  if (!PyArg_ParseTuple(args, "O!O!nOOO", &PyList_Type, &values,
                        &PyBytes_Type, &salt_obj, &nshards, &pointer_type,
                        &error_obj, &fallback))
    return nullptr;
  if (nshards <= 0 || !PyType_Check(pointer_type)) Py_RETURN_NONE;
  uint64_t nn = (uint64_t)nshards;
  const uint8_t *salt = (const uint8_t *)PyBytes_AS_STRING(salt_obj);
  size_t saltlen = (size_t)PyBytes_GET_SIZE(salt_obj);
  Py_ssize_t n = PyList_GET_SIZE(values);
  npy_intp dims[1] = {n};
  PyObject *out = PyArray_SimpleNew(1, dims, NPY_INT64);
  if (!out) return nullptr;
  npy_int64 *od = (npy_int64 *)PyArray_BYTES((PyArrayObject *)out);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *v = PyList_GET_ITEM(values, i);
    uint8_t digest[16];
    if ((PyObject *)Py_TYPE(v) == pointer_type) {
      if (key_bytes(v, digest) < 0) {
        Py_DECREF(out);
        return nullptr;
      }
      od[i] = mod_u128(digest, nn);
      continue;
    }
    if (PyObject_TypeCheck(v, (PyTypeObject *)pointer_type)) {
      Py_DECREF(out);
      Py_RETURN_NONE;
    }
    B2BCtx c;
    b2b_init(&c);
    if (saltlen) b2b_update(&c, salt, saltlen);
    int rc = feed_value(&c, v, pointer_type, error_obj, 0);
    if (rc < 0) {
      Py_DECREF(out);
      return nullptr;
    }
    if (rc == 1) {
      if (fallback_digest(fallback, v, digest) < 0) {
        Py_DECREF(out);
        return nullptr;
      }
    } else {
      b2b_final(&c, digest);
    }
    od[i] = mod_u128(digest, nn);
  }
  return out;
}

/* entries_to_side(entries, on_cols, arity, Pointer)
 *   -> (kb, [col ndarrays]) | None (bail to the Python path).
 * One pass builds what JoinNode._side_from_batch assembles from row
 * entries: the (n,16) key-byte matrix plus every column as a typed array
 * (int64/float64/bool for clean exact-typed columns, object otherwise).
 * Bails whenever the Python screens would: any diff != 1, a non-exact
 * Pointer key, or a join-key column that is not cleanly numeric/bool
 * (string join keys keep their Python-path handling). */
PyObject *entries_to_side(PyObject *, PyObject *args) {
  HIT(H_ENTRIES_TO_SIDE);
  PyObject *entries, *on_cols, *pointer_type;
  Py_ssize_t arity;
  if (!PyArg_ParseTuple(args, "O!O!nO", &PyList_Type, &entries,
                        &PyList_Type, &on_cols, &arity, &pointer_type))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(entries);
  Py_ssize_t k = PyList_GET_SIZE(on_cols);
  if (n == 0 || arity <= 0) Py_RETURN_NONE;
  std::vector<char> is_jk((size_t)arity, 0);
  for (Py_ssize_t c = 0; c < k; c++) {
    Py_ssize_t idx = PyLong_AsSsize_t(PyList_GET_ITEM(on_cols, c));
    if (idx == -1 && PyErr_Occurred()) return nullptr;
    if (idx < 0 || idx >= arity) Py_RETURN_NONE;
    is_jk[(size_t)idx] = 1;
  }
  npy_intp kdims[2] = {n, 16};
  PyObject *kb = PyArray_SimpleNew(2, kdims, NPY_UINT8);
  if (!kb) return nullptr;
  uint8_t *kdata = (uint8_t *)PyArray_BYTES((PyArrayObject *)kb);
  std::vector<ColKind> kinds((size_t)arity, K_UNSET);
  /* pass 1: screens (shape, diffs, exact-Pointer keys) + column kinds */
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) != 3) goto bail;
    {
      PyObject *key = PyTuple_GET_ITEM(e, 0);
      PyObject *row = PyTuple_GET_ITEM(e, 1);
      PyObject *diff = PyTuple_GET_ITEM(e, 2);
      if (!PyLong_Check(diff) || PyLong_AsLong(diff) != 1) {
        if (PyErr_Occurred()) goto fail;
        goto bail;
      }
      if ((PyObject *)Py_TYPE(key) != pointer_type) goto bail;
      if (key_bytes(key, kdata + i * 16) < 0) goto fail;
      if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) != arity) goto bail;
      for (Py_ssize_t c = 0; c < arity; c++) {
        if (kinds[(size_t)c] == K_FAIL) continue;
        PyTypeObject *t = Py_TYPE(PyTuple_GET_ITEM(row, c));
        ColKind kc = t == &PyLong_Type    ? K_INT
                     : t == &PyFloat_Type ? K_FLOAT
                     : t == &PyBool_Type  ? K_BOOL
                                          : K_FAIL;
        if (kinds[(size_t)c] == K_UNSET)
          kinds[(size_t)c] = kc;
        else if (kinds[(size_t)c] != kc)
          kinds[(size_t)c] = K_FAIL;
      }
    }
  }
  for (Py_ssize_t c = 0; c < arity; c++)
    if (is_jk[(size_t)c] && kinds[(size_t)c] == K_FAIL)
      goto bail; /* string/object join keys: Python path semantics */
  /* pass 2: typed column fill */
  {
    PyObject *cols = PyList_New(arity);
    if (!cols) goto fail;
    for (Py_ssize_t c = 0; c < arity; c++) {
      ColKind kind = kinds[(size_t)c];
      npy_intp dims[1] = {n};
      PyObject *arr = nullptr;
      if (kind == K_INT) {
        arr = PyArray_SimpleNew(1, dims, NPY_INT64);
        if (!arr) goto fail_cols;
        npy_int64 *d = (npy_int64 *)PyArray_BYTES((PyArrayObject *)arr);
        for (Py_ssize_t i = 0; i < n; i++) {
          PyObject *v = PyTuple_GET_ITEM(
              PyTuple_GET_ITEM(PyList_GET_ITEM(entries, i), 1), c);
          int overflow = 0;
          long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
          if (overflow || (x == -1 && PyErr_Occurred())) {
            PyErr_Clear();
            Py_DECREF(arr);
            arr = nullptr;
            if (is_jk[(size_t)c]) {
              Py_DECREF(cols);
              goto bail; /* bigint join key: Python bails this side too */
            }
            kind = K_FAIL; /* bigint payload column: keep exact objects */
            break;
          }
          d[i] = (npy_int64)x;
        }
      } else if (kind == K_FLOAT) {
        arr = PyArray_SimpleNew(1, dims, NPY_FLOAT64);
        if (!arr) goto fail_cols;
        npy_double *d = (npy_double *)PyArray_BYTES((PyArrayObject *)arr);
        for (Py_ssize_t i = 0; i < n; i++)
          d[i] = PyFloat_AS_DOUBLE(PyTuple_GET_ITEM(
              PyTuple_GET_ITEM(PyList_GET_ITEM(entries, i), 1), c));
      } else if (kind == K_BOOL) {
        arr = PyArray_SimpleNew(1, dims, NPY_BOOL);
        if (!arr) goto fail_cols;
        npy_bool *d = (npy_bool *)PyArray_BYTES((PyArrayObject *)arr);
        for (Py_ssize_t i = 0; i < n; i++)
          d[i] = PyTuple_GET_ITEM(
                     PyTuple_GET_ITEM(PyList_GET_ITEM(entries, i), 1), c) ==
                 Py_True;
      }
      if (kind == K_FAIL || kind == K_UNSET) {
        arr = PyArray_SimpleNew(1, dims, NPY_OBJECT);
        if (!arr) goto fail_cols;
        PyObject **d = (PyObject **)PyArray_BYTES((PyArrayObject *)arr);
        memset(d, 0, sizeof(PyObject *) * (size_t)n);
        for (Py_ssize_t i = 0; i < n; i++) {
          PyObject *v = PyTuple_GET_ITEM(
              PyTuple_GET_ITEM(PyList_GET_ITEM(entries, i), 1), c);
          Py_INCREF(v);
          d[i] = v;
        }
      }
      PyList_SET_ITEM(cols, c, arr);
    }
    return Py_BuildValue("(NN)", kb, cols);
  fail_cols:
    Py_DECREF(cols);
    goto fail;
  }
bail:
  Py_DECREF(kb);
  Py_RETURN_NONE;
fail:
  Py_DECREF(kb);
  return nullptr;
}

inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

/* match_pairs_i64(l_cols, r_cols) -> (l_idx, r_idx).
 * Hash-join core over dtype-unified int64 code columns, result-identical
 * to _match_join_pairs_multi INCLUDING output order: the larger side
 * probes in row order (ties probe left), and each probe row's matches
 * list the build side ascending. Runs GIL-free over raw buffers. */
PyObject *match_pairs_i64(PyObject *, PyObject *args) {
  HIT(H_MATCH_PAIRS_I64);
  PyObject *l_cols, *r_cols;
  if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &l_cols, &PyList_Type,
                        &r_cols))
    return nullptr;
  Py_ssize_t k = PyList_GET_SIZE(l_cols);
  if (k < 1 || PyList_GET_SIZE(r_cols) != k) {
    PyErr_SetString(PyExc_ValueError, "need matching non-empty column lists");
    return nullptr;
  }
  std::vector<const int64_t *> lp((size_t)k), rp((size_t)k);
  Py_ssize_t nl = -1, nr = -1;
  for (int side = 0; side < 2; side++) {
    PyObject *cols = side == 0 ? l_cols : r_cols;
    for (Py_ssize_t c = 0; c < k; c++) {
      PyObject *col = PyList_GET_ITEM(cols, c);
      if (!PyArray_Check(col)) {
        PyErr_SetString(PyExc_TypeError, "columns must be ndarrays");
        return nullptr;
      }
      PyArrayObject *a = (PyArrayObject *)col;
      if (PyArray_NDIM(a) != 1 || PyArray_TYPE(a) != NPY_INT64 ||
          !PyArray_IS_C_CONTIGUOUS(a)) {
        PyErr_SetString(PyExc_ValueError,
                        "columns must be contiguous 1-D int64");
        return nullptr;
      }
      Py_ssize_t len = PyArray_DIM(a, 0);
      Py_ssize_t &expect = side == 0 ? nl : nr;
      if (expect < 0)
        expect = len;
      else if (expect != len) {
        PyErr_SetString(PyExc_ValueError, "column length mismatch");
        return nullptr;
      }
      (side == 0 ? lp : rp)[(size_t)c] =
          (const int64_t *)PyArray_BYTES(a);
    }
  }
  /* probe = larger side; ties probe left (matches _match_join_pairs) */
  int probe_is_left = nl >= nr;
  const std::vector<const int64_t *> &pc = probe_is_left ? lp : rp;
  const std::vector<const int64_t *> &bc = probe_is_left ? rp : lp;
  Py_ssize_t np_ = probe_is_left ? nl : nr;
  Py_ssize_t nb = probe_is_left ? nr : nl;
  std::vector<int64_t> out_p, out_b;
  if (np_ > 0 && nb > 0) {
    Py_BEGIN_ALLOW_THREADS;
    size_t cap = 8;
    while ((Py_ssize_t)cap < 2 * nb) cap <<= 1;
    std::vector<int64_t> head(cap, -1), nxt((size_t)nb);
    /* reverse-order prepends leave each bucket chain ascending by index */
    for (Py_ssize_t r = nb - 1; r >= 0; r--) {
      uint64_t h = 0;
      for (Py_ssize_t c = 0; c < k; c++)
        h = mix64(h ^ (uint64_t)bc[(size_t)c][r]);
      size_t b = (size_t)h & (cap - 1);
      nxt[(size_t)r] = head[b];
      head[b] = r;
    }
    for (Py_ssize_t i = 0; i < np_; i++) {
      uint64_t h = 0;
      for (Py_ssize_t c = 0; c < k; c++)
        h = mix64(h ^ (uint64_t)pc[(size_t)c][i]);
      for (int64_t j = head[(size_t)h & (cap - 1)]; j != -1;
           j = nxt[(size_t)j]) {
        int eq = 1;
        for (Py_ssize_t c = 0; c < k; c++)
          if (pc[(size_t)c][i] != bc[(size_t)c][j]) {
            eq = 0;
            break;
          }
        if (eq) {
          out_p.push_back(i);
          out_b.push_back(j);
        }
      }
    }
    Py_END_ALLOW_THREADS;
  }
  npy_intp dims[1] = {(npy_intp)out_p.size()};
  PyObject *l_idx = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject *r_idx = PyArray_SimpleNew(1, dims, NPY_INT64);
  if (!l_idx || !r_idx) {
    Py_XDECREF(l_idx);
    Py_XDECREF(r_idx);
    return nullptr;
  }
  if (!out_p.empty()) {
    memcpy(PyArray_BYTES((PyArrayObject *)(probe_is_left ? l_idx : r_idx)),
           out_p.data(), out_p.size() * 8);
    memcpy(PyArray_BYTES((PyArrayObject *)(probe_is_left ? r_idx : l_idx)),
           out_b.data(), out_b.size() * 8);
  }
  return Py_BuildValue("(NN)", l_idx, r_idx);
}

/* session_overlay(buffer, state, upsert) -> entries list | None.
 * The InputSession.flush overlay loops: resolve each buffered update
 * against prior state plus this commit's earlier updates. `state` is
 * only read; the overlay dict lives and dies here. Bails (None) on any
 * malformed buffer entry; comparison errors (e.g. ndarray cells in a
 * remove) propagate exactly as the Python loop would raise them. */
PyObject *session_overlay(PyObject *, PyObject *args) {
  HIT(H_SESSION_OVERLAY);
  PyObject *buffer, *state;
  int upsert;
  if (!PyArg_ParseTuple(args, "O!O!p", &PyList_Type, &buffer, &PyDict_Type,
                        &state, &upsert))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(buffer);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(buffer, i);
    if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) != 3 ||
        !PyLong_Check(PyTuple_GET_ITEM(e, 2)))
      Py_RETURN_NONE;
    if (upsert && PyTuple_GET_ITEM(e, 1) == Py_None) {
      long long d = PyLong_AsLongLong(PyTuple_GET_ITEM(e, 2));
      if (d == -1 && PyErr_Occurred()) return nullptr;
      if (d > 0) Py_RETURN_NONE; /* Python path asserts on this shape */
    }
  }
  PyObject *overlay = PyDict_New();
  PyObject *out = PyList_New(0);
  if (!overlay || !out) {
    Py_XDECREF(overlay);
    Py_XDECREF(out);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(buffer, i);
    PyObject *key = PyTuple_GET_ITEM(e, 0);
    PyObject *row = PyTuple_GET_ITEM(e, 1);
    PyObject *diff = PyTuple_GET_ITEM(e, 2);
    long long d = PyLong_AsLongLong(diff);
    if (d == -1 && PyErr_Occurred()) goto fail;
    /* effective(key): overlay wins (None = removed), else prior state */
    PyObject *prev = PyDict_GetItemWithError(overlay, key);
    if (!prev) {
      if (PyErr_Occurred()) goto fail;
      prev = PyDict_GetItemWithError(state, key);
      if (!prev && PyErr_Occurred()) goto fail;
    }
    if (prev == Py_None) prev = nullptr;
    if (upsert) {
      if (d > 0) {
        if (prev) {
          PyObject *retract = Py_BuildValue("(OOi)", key, prev, -1);
          if (!retract || PyList_Append(out, retract) < 0) {
            Py_XDECREF(retract);
            goto fail;
          }
          Py_DECREF(retract);
        }
        PyObject *ins = Py_BuildValue("(OOi)", key, row, 1);
        if (!ins || PyList_Append(out, ins) < 0) {
          Py_XDECREF(ins);
          goto fail;
        }
        Py_DECREF(ins);
        if (PyDict_SetItem(overlay, key, row) < 0) goto fail;
      } else if (prev) {
        PyObject *retract = Py_BuildValue("(OOi)", key, prev, -1);
        if (!retract || PyList_Append(out, retract) < 0) {
          Py_XDECREF(retract);
          goto fail;
        }
        Py_DECREF(retract);
        if (PyDict_SetItem(overlay, key, Py_None) < 0) goto fail;
      }
    } else {
      if (d < 0 && row == Py_None) {
        if (!prev) continue; /* row-less removal of an absent key */
        row = prev;
      }
      /* appending before the overlay update keeps `row` (possibly
       * borrowed from the overlay) alive across the SetItem below; the
       * Python loop's append-after order is observably identical */
      PyObject *entry = PyTuple_New(3);
      if (!entry) goto fail;
      Py_INCREF(key);
      PyTuple_SET_ITEM(entry, 0, key);
      Py_INCREF(row);
      PyTuple_SET_ITEM(entry, 1, row);
      Py_INCREF(diff);
      PyTuple_SET_ITEM(entry, 2, diff);
      if (PyList_Append(out, entry) < 0) {
        Py_DECREF(entry);
        goto fail;
      }
      Py_DECREF(entry);
      if (d > 0) {
        if (PyDict_SetItem(overlay, key, row) < 0) goto fail;
      } else {
        PyObject *eff = prev ? prev : Py_None;
        int eq = PyObject_RichCompareBool(eff, row, Py_EQ);
        if (eq < 0) goto fail; /* e.g. ndarray cells: Python raises too */
        if (eq && PyDict_SetItem(overlay, key, Py_None) < 0) goto fail;
      }
    }
  }
  Py_DECREF(overlay);
  return out;
fail:
  Py_DECREF(overlay);
  Py_DECREF(out);
  return nullptr;
}

PyMethodDef methods[] = {
    {"pointers_to_bytes", pointers_to_bytes, METH_VARARGS,
     "pointers_to_bytes(keys) -> (n,16) uint8 | None"},
    {"bytes_to_pointers", bytes_to_pointers, METH_VARARGS,
     "bytes_to_pointers(arr, Pointer) -> list[Pointer]"},
    {"hash_join_pairs", hash_join_pairs, METH_VARARGS,
     "hash_join_pairs(lbytes, rbytes) -> (n,16) uint8"},
    {"entry_keys_bytes", entry_keys_bytes, METH_VARARGS,
     "entry_keys_bytes(entries, Pointer) -> (n,16) uint8 | None"},
    {"columns_to_entries", columns_to_entries, METH_VARARGS,
     "columns_to_entries(keys, cols, diffs|None) -> entries"},
    {"join_insert_inner", join_insert_inner, METH_VARARGS,
     "join_insert_inner(l_entries, r_entries, l_on, r_on, l_arr, r_arr, "
     "ERROR, Pointer) -> entries|None"},
    {"consolidate", consolidate, METH_VARARGS,
     "consolidate(entries) -> (entries|None, insert_only)"},
    {"apply_state", apply_state, METH_VARARGS,
     "apply_state(state, entries, insert_only)"},
    {"build_entries", build_entries, METH_VARARGS,
     "build_entries(entries, columns) -> entries"},
    {"filter_truthy", filter_truthy, METH_VARARGS,
     "filter_truthy(entries, col) -> entries|None"},
    {"extract_column", extract_column, METH_VARARGS,
     "extract_column(seq, col, from_entries) -> ndarray|None"},
    {"entry_diffs", entry_diffs, METH_VARARGS,
     "entry_diffs(entries) -> int64 ndarray"},
    {"hash_tuples_batch", hash_tuples_batch, METH_VARARGS,
     "hash_tuples_batch(rows, salt, bare, Pointer, ERROR, fallback) -> "
     "(n,16) uint8"},
    {"shard_values", shard_values, METH_VARARGS,
     "shard_values(values, salt, n, Pointer, ERROR, fallback) -> "
     "int64[n] | None"},
    {"entries_to_side", entries_to_side, METH_VARARGS,
     "entries_to_side(entries, on_cols, arity, Pointer) -> "
     "(kb, cols) | None"},
    {"match_pairs_i64", match_pairs_i64, METH_VARARGS,
     "match_pairs_i64(l_cols, r_cols) -> (l_idx, r_idx)"},
    {"session_overlay", session_overlay, METH_VARARGS,
     "session_overlay(buffer, state, upsert) -> entries | None"},
    {"hit_counts", hit_counts, METH_NOARGS,
     "hit_counts() -> {kernel: calls}"},
    {"kernel_ns", kernel_ns, METH_NOARGS,
     "kernel_ns() -> {kernel: cumulative nanoseconds}"},
    {"reset_hit_counts", reset_hit_counts, METH_NOARGS,
     "reset_hit_counts()"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                         "_enginecore",
                         "Native engine-core kernels",
                         -1,
                         methods,
                         nullptr,
                         nullptr,
                         nullptr,
                         nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__enginecore(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
