/* Native extraction flattener: review dicts -> fixed-shape cell arrays.
 *
 * C implementation of the ingest hot path in gatekeeper_tpu/ir/features.py
 * (the numpy/Python Extractor is the reference and fallback; differential
 * tests in tests/test_native_flatten.py pin exact equivalence, including
 * intern-id assignment order). Interning writes straight into the Python
 * StringTable's _ids dict / _strs list via the CPython API, so ids stay
 * shared with the param encoder and match tables.
 *
 * Counterpart of the JSON->tensor ingestion the reference framework gets
 * from Go's typed unstructured handling (client-go) ahead of OPA
 * evaluation; here it feeds the device program's feature tensors.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

/* kind codes mirrored from ir/prog.py */
enum {
    K_ABSENT = 0,
    K_NULL = 1,
    K_FALSE = 2,
    K_TRUE = 3,
    K_NUM = 4,
    K_STR = 5,
    K_ARR = 6,
    K_OBJ = 7,
};

typedef struct {
    PyObject *ids;   /* StringTable._ids dict */
    PyObject *strs;  /* StringTable._strs list */
    long added;
} Interner;

static long intern_obj(Interner *it, PyObject *s)
{
    PyObject *v = PyDict_GetItemWithError(it->ids, s); /* borrowed */
    if (v != NULL)
        return PyLong_AsLong(v);
    if (PyErr_Occurred())
        return -1;
    Py_ssize_t i = PyList_GET_SIZE(it->strs);
    PyObject *iv = PyLong_FromSsize_t(i);
    if (iv == NULL)
        return -1;
    if (PyDict_SetItem(it->ids, s, iv) < 0) {
        Py_DECREF(iv);
        return -1;
    }
    Py_DECREF(iv);
    if (PyList_Append(it->strs, s) < 0)
        return -1;
    it->added++;
    return (long)i;
}

/* canonical number string: "\x01n" + (str(int(f)) if integral else repr) —
 * byte-identical to ops/strtab.py canon_num */
static long intern_canon(Interner *it, double f)
{
    char buf[64];
    PyObject *s;
    if (floor(f) == f && fabs(f) < 9007199254740992.0) { /* 2**53 */
        snprintf(buf, sizeof buf, "\x01n%lld", (long long)f);
        s = PyUnicode_FromString(buf);
    } else {
        char *ds = PyOS_double_to_string(f, 'r', 0, 0, NULL);
        if (ds == NULL)
            return -1;
        s = PyUnicode_FromFormat("\x01n%s", ds);
        PyMem_Free(ds);
    }
    if (s == NULL)
        return -1;
    long id = intern_obj(it, s);
    Py_DECREF(s);
    return id;
}

static int kind_of(PyObject *v)
{
    if (v == NULL)
        return K_ABSENT;
    if (v == Py_None)
        return K_NULL;
    if (PyBool_Check(v))
        return (v == Py_True) ? K_TRUE : K_FALSE;
    if (PyLong_Check(v) || PyFloat_Check(v))
        return K_NUM;
    if (PyUnicode_Check(v))
        return K_STR;
    if (PyList_Check(v) || PyTuple_Check(v))
        return K_ARR;
    if (PyDict_Check(v))
        return K_OBJ;
    return K_ABSENT;
}

typedef struct {
    int nsegs;
    PyObject **names; /* per seg; NULL for iter segs */
    int *is_iter;
    int ndims;
    long dims[8];
    int32_t *ids;
    float *nums;
    int32_t *nids;
    int8_t *kinds;
    int32_t *keys;      /* may be NULL */
    float *key_nums;    /* may be NULL */
    int32_t *key_nids;  /* may be NULL */
    Interner it;
} Fill;

/* follow consecutive field segs; returns borrowed ref or NULL (absent) */
static PyObject *descend_fields(PyObject *node, Fill *f, int *i)
{
    while (*i < f->nsegs && !f->is_iter[*i]) {
        if (node == NULL || !PyDict_Check(node))
            return NULL;
        node = PyDict_GetItemWithError(node, f->names[*i]);
        if (node == NULL)
            return NULL; /* absent (or error: caller checks PyErr) */
        (*i)++;
    }
    return node;
}

static int put_cell(Fill *f, long off, PyObject *v)
{
    int k = kind_of(v);
    f->kinds[off] = (int8_t)k;
    if (k == K_STR) {
        long id = intern_obj(&f->it, v);
        if (id < 0)
            return -1;
        f->ids[off] = (int32_t)id;
    } else if (k == K_NUM) {
        double d = PyFloat_Check(v) ? PyFloat_AS_DOUBLE(v)
                                    : PyLong_AsDouble(v);
        if (d == -1.0 && PyErr_Occurred())
            return -1;
        f->nums[off] = (float)d;
        long id = intern_canon(&f->it, d);
        if (id < 0)
            return -1;
        f->nids[off] = (int32_t)id;
    } else if (k == K_TRUE || k == K_FALSE) {
        f->nums[off] = (k == K_TRUE) ? 1.0f : 0.0f;
    }
    return 0;
}

static int put_key_num(Fill *f, long off, double kd)
{
    f->key_nums[off] = (float)kd;
    long id = intern_canon(&f->it, kd);
    if (id < 0)
        return -1;
    f->key_nids[off] = (int32_t)id;
    return 0;
}

static int fill_rec(Fill *f, long off, PyObject *node, int i, int depth);

static int put_key(Fill *f, long sub, PyObject *key_or_null, double key_num,
                   int is_str_key, int depth)
{
    if (f->keys == NULL || depth != f->ndims - 1)
        return 0;
    if (is_str_key) {
        long id = intern_obj(&f->it, key_or_null);
        if (id < 0)
            return -1;
        f->keys[sub] = (int32_t)id;
        return 0;
    }
    return put_key_num(f, sub, key_num);
}

static int fill_child(Fill *f, long off, long j, PyObject *key_or_null,
                      double key_num, int is_str_key, PyObject *v, int i,
                      int depth, int last)
{
    long sub = off * f->dims[depth] + j;
    /* intern order mirrors the Python reference exactly: value before
     * key on the innermost axis, key before descent otherwise (ids must
     * be assigned identically for differential bit-equality) */
    if (last) {
        if (put_cell(f, sub, v) < 0)
            return -1;
        return put_key(f, sub, key_or_null, key_num, is_str_key, depth);
    }
    if (put_key(f, sub, key_or_null, key_num, is_str_key, depth) < 0)
        return -1;
    return fill_rec(f, sub, v, i + 1, depth + 1);
}

static int fill_rec(Fill *f, long off, PyObject *node, int i, int depth)
{
    node = descend_fields(node, f, &i);
    if (node == NULL)
        return PyErr_Occurred() ? -1 : 0;
    if (i == f->nsegs) {
        /* trailing-cell offset: remaining dims (none: i consumed all
         * iter segs) — off is the full linear index */
        return put_cell(f, off, node);
    }
    /* segs[i] is an iter seg */
    int last = (i == f->nsegs - 1);
    long cap = f->dims[depth];
    if (PyDict_Check(node)) {
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        long j = 0;
        while (PyDict_Next(node, &pos, &k, &v)) {
            if (j >= cap)
                break;
            int is_str = PyUnicode_Check(k);
            double kd = 0.0;
            if (!is_str) {
                kd = PyFloat_Check(k) ? PyFloat_AS_DOUBLE(k)
                                      : PyLong_AsDouble(k);
                if (kd == -1.0 && PyErr_Occurred())
                    return -1;
            }
            if (fill_child(f, off, j, k, kd, is_str, v, i, depth, last) < 0)
                return -1;
            j++;
        }
        return 0;
    }
    if (PyList_Check(node) || PyTuple_Check(node)) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(node);
        PyObject **items = PySequence_Fast_ITEMS(node);
        for (Py_ssize_t j = 0; j < n && j < cap; j++) {
            if (fill_child(f, off, (long)j, NULL, (double)j, 0, items[j],
                           i, depth, last) < 0)
                return -1;
        }
        return 0;
    }
    return 0; /* scalar where a collection was expected: absent */
}

/* ---------------------------------------------------------- entry points */

static int parse_segs(PyObject *segs, Fill *f, PyObject ***names_out,
                      int **iter_out)
{
    Py_ssize_t n = PyTuple_GET_SIZE(segs);
    PyObject **names = PyMem_Calloc(n ? n : 1, sizeof(PyObject *));
    int *is_iter = PyMem_Calloc(n ? n : 1, sizeof(int));
    if (names == NULL || is_iter == NULL) {
        PyMem_Free(names);
        PyMem_Free(is_iter);
        PyErr_NoMemory();
        return -1;
    }
    for (Py_ssize_t k = 0; k < n; k++) {
        PyObject *seg = PyTuple_GET_ITEM(segs, k);
        is_iter[k] = PyObject_IsTrue(PyTuple_GET_ITEM(seg, 0));
        names[k] = PyTuple_GET_ITEM(seg, 1); /* borrowed */
    }
    f->nsegs = (int)n;
    *names_out = names;
    *iter_out = is_iter;
    return 0;
}

static void *buf_ptr(PyObject *obj, Py_buffer *view, int *ok)
{
    if (obj == Py_None)
        return NULL;
    if (PyObject_GetBuffer(obj, view, PyBUF_CONTIG) < 0) {
        *ok = 0;
        return NULL;
    }
    return view->buf;
}

static PyObject *root_of(PyObject *review, PyObject *root_name)
{
    /* "review" -> the review dict itself; else review[root] if dict */
    const char *r = PyUnicode_AsUTF8(root_name);
    if (r != NULL && strcmp(r, "review") == 0)
        return review;
    PyObject *v = PyDict_Check(review)
        ? PyDict_GetItemWithError(review, root_name) : NULL;
    if (v != NULL && !PyDict_Check(v))
        return NULL;
    return v;
}

static PyObject *py_fill_slot(PyObject *self, PyObject *args)
{
    PyObject *reviews, *root_name, *segs, *dims_t;
    PyObject *o_ids, *o_nums, *o_nids, *o_kinds, *o_keys, *o_knums,
        *o_knids, *ids_dict, *strs_list;
    if (!PyArg_ParseTuple(args, "O!OO!O!OOOOOOOO!O!",
                          &PyList_Type, &reviews, &root_name,
                          &PyTuple_Type, &segs, &PyTuple_Type, &dims_t,
                          &o_ids, &o_nums, &o_nids, &o_kinds, &o_keys,
                          &o_knums, &o_knids,
                          &PyDict_Type, &ids_dict,
                          &PyList_Type, &strs_list))
        return NULL;

    Fill f;
    memset(&f, 0, sizeof f);
    f.it.ids = ids_dict;
    f.it.strs = strs_list;
    f.ndims = (int)PyTuple_GET_SIZE(dims_t);
    if (f.ndims > 8) {
        PyErr_SetString(PyExc_ValueError, ">8 iteration axes");
        return NULL;
    }
    for (int d = 0; d < f.ndims; d++)
        f.dims[d] = PyLong_AsLong(PyTuple_GET_ITEM(dims_t, d));

    Py_buffer b_ids, b_nums, b_nids, b_kinds, b_keys, b_knums, b_knids;
    int ok = 1;
    int held_keys = 0;
    f.ids = buf_ptr(o_ids, &b_ids, &ok);
    f.nums = buf_ptr(o_nums, &b_nums, &ok);
    f.nids = buf_ptr(o_nids, &b_nids, &ok);
    f.kinds = buf_ptr(o_kinds, &b_kinds, &ok);
    if (ok && o_keys != Py_None) {
        f.keys = buf_ptr(o_keys, &b_keys, &ok);
        f.key_nums = buf_ptr(o_knums, &b_knums, &ok);
        f.key_nids = buf_ptr(o_knids, &b_knids, &ok);
        held_keys = ok;
    }
    PyObject **names = NULL;
    int *is_iter = NULL;
    PyObject *result = NULL;
    if (!ok || parse_segs(segs, &f, &names, &is_iter) < 0)
        goto done;
    f.names = names;
    f.is_iter = is_iter;

    Py_ssize_t n_reviews = PyList_GET_SIZE(reviews);
    for (Py_ssize_t n = 0; n < n_reviews; n++) {
        PyObject *review = PyList_GET_ITEM(reviews, n);
        PyObject *node = root_of(review, root_name);
        if (node == NULL) {
            if (PyErr_Occurred())
                goto done;
            continue;
        }
        if (fill_rec(&f, (long)n, node, 0, 0) < 0)
            goto done;
    }
    result = PyLong_FromLong(f.it.added);

done:
    PyMem_Free(names);
    PyMem_Free(is_iter);
    if (f.ids) PyBuffer_Release(&b_ids);
    if (f.nums) PyBuffer_Release(&b_nums);
    if (f.nids) PyBuffer_Release(&b_nids);
    if (f.kinds) PyBuffer_Release(&b_kinds);
    if (held_keys) {
        PyBuffer_Release(&b_keys);
        PyBuffer_Release(&b_knums);
        PyBuffer_Release(&b_knids);
    }
    return result;
}

static PyObject *py_fill_count(PyObject *self, PyObject *args)
{
    PyObject *reviews, *root_name, *segs, *o_counts, *o_kinds;
    if (!PyArg_ParseTuple(args, "O!OO!OO", &PyList_Type, &reviews,
                          &root_name, &PyTuple_Type, &segs, &o_counts,
                          &o_kinds))
        return NULL;
    Fill f;
    memset(&f, 0, sizeof f);
    PyObject **names = NULL;
    int *is_iter = NULL;
    if (parse_segs(segs, &f, &names, &is_iter) < 0)
        return NULL;
    f.names = names;
    f.is_iter = is_iter;
    Py_buffer b_counts, b_kinds;
    int ok = 1;
    float *counts = buf_ptr(o_counts, &b_counts, &ok);
    int8_t *kinds = buf_ptr(o_kinds, &b_kinds, &ok);
    PyObject *result = NULL;
    if (!ok)
        goto done;
    Py_ssize_t n_reviews = PyList_GET_SIZE(reviews);
    for (Py_ssize_t n = 0; n < n_reviews; n++) {
        PyObject *review = PyList_GET_ITEM(reviews, n);
        PyObject *node = root_of(review, root_name);
        int i = 0;
        node = descend_fields(node, &f, &i);
        if (PyErr_Occurred())
            goto done;
        if (node == NULL || i < f.nsegs)
            continue;
        int k = kind_of(node);
        kinds[n] = (int8_t)k;
        if (k == K_ARR || k == K_OBJ || k == K_STR) {
            Py_ssize_t len = PyObject_Length(node);
            if (len < 0)
                goto done;
            counts[n] = (float)len;
        }
    }
    result = Py_NewRef(Py_None);
done:
    PyMem_Free(names);
    PyMem_Free(is_iter);
    if (counts) PyBuffer_Release(&b_counts);
    if (kinds) PyBuffer_Release(&b_kinds);
    return result;
}

static PyObject *py_slot_sizes(PyObject *self, PyObject *args);

/* sizes prepass: max collection length per iter-seg position */
typedef struct {
    Fill *f;
    long maxes[8];
} Sizes;

static void sizes_rec(Sizes *sz, PyObject *node, int i, int depth)
{
    node = descend_fields(node, sz->f, &i);
    if (node == NULL || i >= sz->f->nsegs)
        return;
    Py_ssize_t n;
    if (PyDict_Check(node)) {
        n = PyDict_GET_SIZE(node);
        if ((long)n > sz->maxes[depth])
            sz->maxes[depth] = (long)n;
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        while (PyDict_Next(node, &pos, &k, &v))
            sizes_rec(sz, v, i + 1, depth + 1);
    } else if (PyList_Check(node) || PyTuple_Check(node)) {
        n = PySequence_Fast_GET_SIZE(node);
        if ((long)n > sz->maxes[depth])
            sz->maxes[depth] = (long)n;
        PyObject **items = PySequence_Fast_ITEMS(node);
        for (Py_ssize_t j = 0; j < n; j++)
            sizes_rec(sz, items[j], i + 1, depth + 1);
    }
}

static PyObject *py_slot_sizes(PyObject *self, PyObject *args)
{
    PyObject *reviews, *root_name, *segs;
    if (!PyArg_ParseTuple(args, "O!OO!", &PyList_Type, &reviews,
                          &root_name, &PyTuple_Type, &segs))
        return NULL;
    Fill f;
    memset(&f, 0, sizeof f);
    PyObject **names = NULL;
    int *is_iter = NULL;
    if (parse_segs(segs, &f, &names, &is_iter) < 0)
        return NULL;
    f.names = names;
    f.is_iter = is_iter;
    int ndims = 0;
    for (int k = 0; k < f.nsegs; k++)
        if (is_iter[k])
            ndims++;
    if (ndims > 8) {
        PyMem_Free(names);
        PyMem_Free(is_iter);
        PyErr_SetString(PyExc_ValueError, ">8 iteration axes");
        return NULL;
    }
    Sizes sz;
    memset(&sz, 0, sizeof sz);
    sz.f = &f;
    Py_ssize_t n_reviews = PyList_GET_SIZE(reviews);
    for (Py_ssize_t n = 0; n < n_reviews; n++) {
        PyObject *review = PyList_GET_ITEM(reviews, n);
        PyObject *node = root_of(review, root_name);
        if (node != NULL)
            sizes_rec(&sz, node, 0, 0);
        if (PyErr_Occurred()) {
            PyMem_Free(names);
            PyMem_Free(is_iter);
            return NULL;
        }
    }
    PyObject *out = PyList_New(ndims);
    for (int d = 0; d < ndims; d++)
        PyList_SET_ITEM(out, d, PyLong_FromLong(sz.maxes[d]));
    PyMem_Free(names);
    PyMem_Free(is_iter);
    return out;
}

static PyMethodDef methods[] = {
    {"fill_slot", py_fill_slot, METH_VARARGS,
     "Fill one slot's cell arrays from a review batch."},
    {"fill_count", py_fill_count, METH_VARARGS,
     "Fill a count-mode slot."},
    {"slot_sizes", py_slot_sizes, METH_VARARGS,
     "Max collection length per iteration axis."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_flatten",
    "Native extraction flattener (see gatekeeper_tpu/ir/features.py).",
    -1, methods,
};

PyMODINIT_FUNC PyInit__flatten(void)
{
    return PyModule_Create(&module);
}
