/* libwhisper_tpu.so — the whisper.h C ABI over whisper_tpu_torch, the
 * PyTorch + CUDA port.
 *
 * A C program written against the reference whisper.h links against this
 * library instead (reference: include/whisper.h:1-676; examples/main).
 * Each exported function acquires the GIL of an embedded CPython
 * interpreter and marshals into whisper_tpu_torch.capi, so the port's
 * engine (the decode loops and the CUDA kernels on the card) sits behind
 * the plain C surface.  This file is native/wtpu_capi.cpp with four
 * changes: the module it imports, where it finds the repository root, the
 * use_gpu / gpu_device fields it passes on (they choose the device), and
 * the name in its comments and messages.
 *
 * Coverage: the core transcription workflow (init/free, full/
 * full_with_state/full_parallel, every segment/token accessor, vocab and
 * language introspection, tokenize, pcm_to_mel, timings) plus ALL five
 * whisper_full_params callbacks (new_segment, progress, encoder_begin,
 * abort, logits_filter) via C->Python trampolines and the in-struct
 * grammar_rules/i_start_rule/grammar_penalty (marshalled into the
 * native GBNF engine; reference: include/whisper.h:449-473, 546-551).
 *
 * Build:  python -c "from whisper_tpu_torch import capi; print(capi.library_path())"
 * (build/whisper_tpu_torch/capi/libwhisper_tpu.so, linked against the
 * running interpreter's shared libpython).  The interpreter locates the
 * repo root from this library's own path under build/ (override with
 * WHISPER_TPU_ROOT); contexts whose params say use_gpu run on the device
 * that WHISPER_TPU_TORCH_DEVICE names, else on cuda:<gpu_device>.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>
#include <unordered_map>

#include "whisper_tpu.h"

// ---------------------------------------------------------------------------
// interpreter bootstrap
// ---------------------------------------------------------------------------

static PyObject * g_capi = nullptr;   // whisper_tpu_torch.capi module
static PyObject * g_np = nullptr;     // numpy module

static void ensure_python() {
    static std::once_flag once;
    std::call_once(once, [] {
        const bool own = !Py_IsInitialized();
        if (own) {
            // When this library itself arrives via dlopen(RTLD_LOCAL) —
            // a perl/node/java FFI client, not an exe linked against us —
            // its libpython dependency gets LOCAL symbol scope, and every
            // CPython extension module (math, numpy, ...) fails with
            // "undefined symbol: PyFloat_Type".  Re-open libpython with
            // RTLD_GLOBAL to promote its symbols before initializing.
            char pylib[64];
            snprintf(pylib, sizeof(pylib), "libpython%d.%d.so.1.0",
                     PY_MAJOR_VERSION, PY_MINOR_VERSION);
            if (!dlopen(pylib, RTLD_NOW | RTLD_GLOBAL | RTLD_NOLOAD)) {
                dlopen(pylib, RTLD_NOW | RTLD_GLOBAL);
            }
            Py_InitializeEx(0);
        }
        PyGILState_STATE g = PyGILState_Ensure();

        // repo root: $WHISPER_TPU_ROOT, or the directory that holds the
        // build/whisper_tpu_torch/ this library (or the link to it) is in
        std::string root = ".";
        if (const char * env = getenv("WHISPER_TPU_ROOT")) {
            root = env;
        } else {
            Dl_info info;
            if (dladdr((void *) &ensure_python, &info) && info.dli_fname) {
                std::string so = info.dli_fname;
                if (char * real = realpath(info.dli_fname, nullptr)) {
                    so = real;
                    free(real);
                }
                const size_t p = so.rfind("/build/whisper_tpu_torch/");
                if (p != std::string::npos) {
                    root = p == 0 ? "/" : so.substr(0, p);
                }
            }
        }
        PyObject * sys_path = PySys_GetObject("path");  // borrowed
        PyObject * r = PyUnicode_FromString(root.c_str());
        PyList_Insert(sys_path, 0, r);
        Py_DECREF(r);

        g_np = PyImport_ImportModule("numpy");
        g_capi = PyImport_ImportModule("whisper_tpu_torch.capi");
        if (!g_capi) {
            PyErr_Print();
            fprintf(stderr, "whisper_tpu_torch: failed to import "
                            "whisper_tpu_torch.capi (root=%s)\n",
                    root.c_str());
        }
        PyGILState_Release(g);
        if (own) {
            // drop the GIL so any thread can take it via PyGILState_Ensure
            PyEval_SaveThread();
        }
    });
}

struct Gil {
    PyGILState_STATE st;
    Gil() { ensure_python(); st = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(st); }
};

// opaque handles: boxes around Python objects
struct whisper_timings_box {
    float sample_ms, encode_ms, decode_ms, batchd_ms, prompt_ms;
};

struct whisper_state;   // fwd: contexts carry a lazily-made self-state

struct whisper_context {
    PyObject * obj;
    struct whisper_state * self_state = nullptr;  // see ctx_self_state()
    std::vector<float> logits_buf;
    whisper_timings_box timings_box;
    // storage for returned const char*: whisper.h pointers stay valid for
    // the context lifetime (clients cache whisper_token_to_str results),
    // so strings are interned per distinct value, never evicted
    std::deque<std::string> strings;
    std::unordered_map<std::string, const std::string *> interned;
    const char * keep(PyObject * s) {
        if (!s) return "";
        const char * u = PyUnicode_AsUTF8(s);
        std::string v = u ? u : "";
        auto it = interned.find(v);
        if (it != interned.end()) return it->second->c_str();
        strings.push_back(std::move(v));
        interned.emplace(strings.back(), &strings.back());
        return strings.back().c_str();
    }
};
struct whisper_state {
    PyObject * obj;
    std::vector<float> logits_buf;
    std::deque<std::string> strings;
    std::unordered_map<std::string, const std::string *> interned;
    const char * keep(PyObject * s) {
        if (!s) return "";
        const char * u = PyUnicode_AsUTF8(s);
        std::string v = u ? u : "";
        auto it = interned.find(v);
        if (it != interned.end()) return it->second->c_str();
        strings.push_back(std::move(v));
        interned.emplace(strings.back(), &strings.back());
        return strings.back().c_str();
    }
};

// The whisper_state* passed to C callbacks installed via whisper_full /
// whisper_full_parallel (the no-explicit-state entry points): the
// WhisperContext doubles as its own default state on the Python side
// (every *_from_state accessor works on it), so the box wraps a second
// reference to ctx->obj.  Mirrors the reference, where those callbacks
// receive ctx->state — a client calling e.g.
// whisper_full_n_tokens_from_state(state) inside a callback must not
// segfault.  Freed by whisper_free.
static whisper_state * ctx_self_state(whisper_context * ctx) {
    if (!ctx->self_state) {
        ctx->self_state = new whisper_state();
        Py_INCREF(ctx->obj);
        ctx->self_state->obj = ctx->obj;
    }
    return ctx->self_state;
}

// call g_capi.<name>(args...) -> new ref (nullptr on error, error printed)
static PyObject * call(const char * name, PyObject * args) {
    if (!g_capi) { Py_XDECREF(args); return nullptr; }
    PyObject * fn = PyObject_GetAttrString(g_capi, name);
    if (!fn) { PyErr_Print(); Py_XDECREF(args); return nullptr; }
    PyObject * out = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if (!out) PyErr_Print();
    return out;
}

static long call_long(const char * name, PyObject * args, long dflt = -1) {
    PyObject * r = call(name, args);
    if (!r) return dflt;
    long v = PyLong_AsLong(r);
    if (PyErr_Occurred()) { PyErr_Clear(); v = dflt; }
    Py_DECREF(r);
    return v;
}

static double call_double(const char * name, PyObject * args,
                          double dflt = 0.0) {
    PyObject * r = call(name, args);
    if (!r) return dflt;
    double v = PyFloat_AsDouble(r);
    if (PyErr_Occurred()) { PyErr_Clear(); v = dflt; }
    Py_DECREF(r);
    return v;
}

// float* -> numpy f32 array (copies: the caller's buffer has no lifetime
// guarantee past the call)
static PyObject * np_from_f32(const float * samples, int n) {
    PyObject * mv = PyMemoryView_FromMemory(
        (char *) samples, (Py_ssize_t) n * 4, PyBUF_READ);
    PyObject * arr = PyObject_CallMethod(g_np, "frombuffer", "Os", mv, "<f4");
    Py_DECREF(mv);
    if (!arr) { PyErr_Print(); return nullptr; }
    PyObject * copy = PyObject_CallMethod(arr, "copy", nullptr);
    Py_DECREF(arr);
    return copy;
}

// ---------------------------------------------------------------------------
// callback trampolines (C fn pointer wrapped as a Python callable)
// ---------------------------------------------------------------------------

struct CbBox {
    whisper_context * ctx;
    whisper_state * state;   // never null: explicit state or ctx self-state
    void * fn;
    void * user_data;
};

static PyObject * new_segment_tramp(PyObject * self, PyObject * args) {
    CbBox * box = (CbBox *) PyCapsule_GetPointer(self, "wtpu.cb");
    PyObject * ctx_obj;
    int n_new;
    if (!PyArg_ParseTuple(args, "Oi", &ctx_obj, &n_new)) return nullptr;
    ((whisper_new_segment_callback) box->fn)(box->ctx, box->state, n_new,
                                             box->user_data);
    Py_RETURN_NONE;
}

static PyObject * progress_tramp(PyObject * self, PyObject * args) {
    CbBox * box = (CbBox *) PyCapsule_GetPointer(self, "wtpu.cb");
    PyObject * ctx_obj;
    int progress;
    if (!PyArg_ParseTuple(args, "Oi", &ctx_obj, &progress)) return nullptr;
    ((whisper_progress_callback) box->fn)(box->ctx, box->state, progress,
                                          box->user_data);
    Py_RETURN_NONE;
}

static PyObject * encoder_begin_tramp(PyObject * self, PyObject * args) {
    // python side calls params.encoder_begin_callback(ctx); returning
    // false aborts before the window is encoded (api.py window loop)
    CbBox * box = (CbBox *) PyCapsule_GetPointer(self, "wtpu.cb");
    (void) args;
    bool cont = ((whisper_encoder_begin_callback) box->fn)(
        box->ctx, box->state, box->user_data);
    return PyBool_FromLong(cont);
}

static PyObject * abort_tramp(PyObject * self, PyObject * args) {
    // C abort_callback(user_data) -> true means stop (whisper.h semantics)
    CbBox * box = (CbBox *) PyCapsule_GetPointer(self, "wtpu.cb");
    (void) args;
    bool stop = ((whisper_abort_callback) box->fn)(box->user_data);
    return PyBool_FromLong(stop);
}

static PyObject * logits_filter_tramp(PyObject * self, PyObject * args) {
    // python calls logits_filter_callback(tokens_cur, logits) with the
    // current-sequence token ids and a writable float64 (V,) array
    // (decode/host_filters.py).  Marshal to the C signature: token_data
    // array + mutable float* logits, then write mutations back.
    CbBox * box = (CbBox *) PyCapsule_GetPointer(self, "wtpu.cb");
    PyObject * tokens_list;
    PyObject * logits_arr;
    if (!PyArg_ParseTuple(args, "OO", &tokens_list, &logits_arr))
        return nullptr;

    Py_ssize_t n = PySequence_Size(tokens_list);
    if (n < 0) { PyErr_Clear(); n = 0; }
    std::vector<whisper_token_data> td((size_t) n);
    for (Py_ssize_t i = 0; i < n; i++) {
        memset(&td[i], 0, sizeof(td[i]));
        PyObject * it = PySequence_GetItem(tokens_list, i);
        td[i].id = it ? (whisper_token) PyLong_AsLong(it) : 0;
        if (PyErr_Occurred()) PyErr_Clear();
        td[i].t0 = td[i].t1 = -1;
        td[i].t_dtw = -1;
        Py_XDECREF(it);
    }

    PyObject * f32 = PyObject_CallMethod(logits_arr, "astype", "s",
                                         "float32");
    if (!f32) { PyErr_Print(); Py_RETURN_NONE; }
    Py_buffer view;
    if (PyObject_GetBuffer(f32, &view,
                           PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) == 0) {
        // snapshot before the callback so only entries the C callback
        // actually wrote flow back: blanket-assigning the f32 copy over
        // the host chain's float64 array would round EVERY logit and
        // could flip near-tie argmax/multinomial picks vs the Python
        // callback path
        const size_t nv = (size_t) (view.len / (Py_ssize_t) sizeof(float));
        std::vector<float> before((float *) view.buf,
                                  (float *) view.buf + nv);
        ((whisper_logits_filter_callback) box->fn)(
            box->ctx, box->state, td.data(), (int) n,
            (float *) view.buf, box->user_data);
        Py_buffer dview;
        bool wrote = false;
        if (PyObject_GetBuffer(logits_arr, &dview,
                               PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) == 0) {
            if (dview.len == (Py_ssize_t) (nv * sizeof(double))) {
                double * dst = (double *) dview.buf;
                const float * after = (const float *) view.buf;
                for (size_t i = 0; i < nv; i++)
                    if (after[i] != before[i]
                        || (after[i] != after[i] && before[i] == before[i]))
                        dst[i] = (double) after[i];
                wrote = true;
            }
            PyBuffer_Release(&dview);
        } else {
            PyErr_Clear();
        }
        if (!wrote) {
            // non-f64 or non-contiguous host array: fall back to the
            // whole-array assignment (still correct, just f32-rounded)
            PyObject * slice = PySlice_New(nullptr, nullptr, nullptr);
            if (PyObject_SetItem(logits_arr, slice, f32) != 0) PyErr_Print();
            Py_DECREF(slice);
        }
        PyBuffer_Release(&view);
    } else {
        PyErr_Print();
    }
    Py_DECREF(f32);
    Py_RETURN_NONE;
}

static void cb_capsule_free(PyObject * cap) {
    delete (CbBox *) PyCapsule_GetPointer(cap, "wtpu.cb");
}

static PyMethodDef g_seg_def = {"new_segment", new_segment_tramp,
                                METH_VARARGS, nullptr};
static PyMethodDef g_prog_def = {"progress", progress_tramp,
                                 METH_VARARGS, nullptr};
static PyMethodDef g_encb_def = {"encoder_begin", encoder_begin_tramp,
                                 METH_VARARGS, nullptr};
static PyMethodDef g_abort_def = {"abort", abort_tramp,
                                  METH_VARARGS, nullptr};
static PyMethodDef g_lfilt_def = {"logits_filter", logits_filter_tramp,
                                  METH_VARARGS, nullptr};

static PyObject * make_trampoline(PyMethodDef * def, whisper_context * ctx,
                                  whisper_state * state,
                                  void * fn, void * user_data) {
    CbBox * box = new CbBox{ctx, state, fn, user_data};
    PyObject * cap = PyCapsule_New(box, "wtpu.cb", cb_capsule_free);
    PyObject * f = PyCFunction_New(def, cap);
    Py_DECREF(cap);
    return f;
}

// ---------------------------------------------------------------------------
// params conversion
// ---------------------------------------------------------------------------

static void set_attr(PyObject * o, const char * k, PyObject * v) {
    PyObject_SetAttrString(o, k, v);
    Py_DECREF(v);
}

static PyObject * params_to_py(whisper_context * cctx,
                               whisper_state * cstate,
                               const whisper_full_params & p) {
    PyObject * args = Py_BuildValue("(i)", (int) p.strategy);
    PyObject * fp = call("whisper_full_default_params", args);
    if (!fp) return nullptr;

    set_attr(fp, "n_max_text_ctx", PyLong_FromLong(p.n_max_text_ctx));
    set_attr(fp, "offset_ms", PyLong_FromLong(p.offset_ms));
    set_attr(fp, "duration_ms", PyLong_FromLong(p.duration_ms));
    set_attr(fp, "translate", PyBool_FromLong(p.translate));
    set_attr(fp, "no_context", PyBool_FromLong(p.no_context));
    set_attr(fp, "no_timestamps", PyBool_FromLong(p.no_timestamps));
    set_attr(fp, "single_segment", PyBool_FromLong(p.single_segment));
    set_attr(fp, "print_special", PyBool_FromLong(p.print_special));
    set_attr(fp, "print_progress", PyBool_FromLong(p.print_progress));
    set_attr(fp, "print_realtime", PyBool_FromLong(p.print_realtime));
    set_attr(fp, "print_timestamps", PyBool_FromLong(p.print_timestamps));
    set_attr(fp, "token_timestamps", PyBool_FromLong(p.token_timestamps));
    set_attr(fp, "thold_pt", PyFloat_FromDouble(p.thold_pt));
    set_attr(fp, "thold_ptsum", PyFloat_FromDouble(p.thold_ptsum));
    set_attr(fp, "max_len", PyLong_FromLong(p.max_len));
    set_attr(fp, "split_on_word", PyBool_FromLong(p.split_on_word));
    set_attr(fp, "max_tokens", PyLong_FromLong(p.max_tokens));
    set_attr(fp, "debug_mode", PyBool_FromLong(p.debug_mode));
    set_attr(fp, "audio_ctx", PyLong_FromLong(p.audio_ctx));
    set_attr(fp, "tdrz_enable", PyBool_FromLong(p.tdrz_enable));
    if (p.suppress_regex)
        set_attr(fp, "suppress_regex", PyUnicode_FromString(p.suppress_regex));
    if (p.initial_prompt)
        set_attr(fp, "initial_prompt", PyUnicode_FromString(p.initial_prompt));
    if (p.prompt_tokens && p.prompt_n_tokens > 0) {
        PyObject * lst = PyList_New(p.prompt_n_tokens);
        for (int i = 0; i < p.prompt_n_tokens; i++)
            PyList_SET_ITEM(lst, i, PyLong_FromLong(p.prompt_tokens[i]));
        set_attr(fp, "prompt_tokens", lst);
    }
    set_attr(fp, "language", p.language
             ? PyUnicode_FromString(p.language) : PyUnicode_FromString(""));
    set_attr(fp, "detect_language", PyBool_FromLong(p.detect_language));
    set_attr(fp, "suppress_blank", PyBool_FromLong(p.suppress_blank));
    set_attr(fp, "suppress_nst", PyBool_FromLong(p.suppress_nst));
    set_attr(fp, "temperature", PyFloat_FromDouble(p.temperature));
    set_attr(fp, "max_initial_ts", PyFloat_FromDouble(p.max_initial_ts));
    set_attr(fp, "length_penalty", PyFloat_FromDouble(p.length_penalty));
    set_attr(fp, "temperature_inc", PyFloat_FromDouble(p.temperature_inc));
    set_attr(fp, "entropy_thold", PyFloat_FromDouble(p.entropy_thold));
    set_attr(fp, "logprob_thold", PyFloat_FromDouble(p.logprob_thold));
    set_attr(fp, "no_speech_thold", PyFloat_FromDouble(p.no_speech_thold));

    PyObject * greedy = PyObject_GetAttrString(fp, "greedy");
    if (greedy) {
        set_attr(greedy, "best_of", PyLong_FromLong(p.greedy.best_of));
        Py_DECREF(greedy);
    }
    PyObject * beam = PyObject_GetAttrString(fp, "beam_search");
    if (beam) {
        set_attr(beam, "beam_size", PyLong_FromLong(p.beam_search.beam_size));
        set_attr(beam, "patience", PyFloat_FromDouble(p.beam_search.patience));
        Py_DECREF(beam);
    }

    if (p.new_segment_callback)
        set_attr(fp, "new_segment_callback", make_trampoline(
            &g_seg_def, cctx, cstate, (void *) p.new_segment_callback,
            p.new_segment_callback_user_data));
    if (p.progress_callback)
        set_attr(fp, "progress_callback", make_trampoline(
            &g_prog_def, cctx, cstate, (void *) p.progress_callback,
            p.progress_callback_user_data));
    if (p.encoder_begin_callback)
        set_attr(fp, "encoder_begin_callback", make_trampoline(
            &g_encb_def, cctx, cstate, (void *) p.encoder_begin_callback,
            p.encoder_begin_callback_user_data));
    if (p.abort_callback)
        set_attr(fp, "abort_callback", make_trampoline(
            &g_abort_def, cctx, cstate, (void *) p.abort_callback,
            p.abort_callback_user_data));
    if (p.logits_filter_callback)
        set_attr(fp, "logits_filter_callback", make_trampoline(
            &g_lfilt_def, cctx, cstate, (void *) p.logits_filter_callback,
            p.logits_filter_callback_user_data));

    // in-struct grammar (reference: whisper.h:546-551): END-terminated
    // element arrays -> whisper_tpu_torch.capi.whisper_grammar_from_c_rules
    if (p.grammar_rules && p.n_grammar_rules > 0) {
        PyObject * rules = PyList_New((Py_ssize_t) p.n_grammar_rules);
        for (size_t i = 0; i < p.n_grammar_rules; i++) {
            const whisper_grammar_element * r = p.grammar_rules[i];
            int len = 0;
            while (r[len].type != 0) len++;
            len++;  // include the END terminator (grammar.py keeps it)
            PyObject * rl = PyList_New(len);
            for (int j = 0; j < len; j++)
                PyList_SET_ITEM(rl, j, Py_BuildValue(
                    "(iI)", r[j].type, (unsigned int) r[j].value));
            PyList_SET_ITEM(rules, i, rl);
        }
        PyObject * g = call("whisper_grammar_from_c_rules",
                            Py_BuildValue("(Nn)", rules,
                                          (Py_ssize_t) p.i_start_rule));
        if (!g) {
            // reference rejects unusable grammar params; proceeding
            // without the grammar would return success with output
            // violating the caller's constraint
            fprintf(stderr, "whisper_tpu_torch: failed to marshal grammar_rules; "
                            "rejecting whisper_full params\n");
            Py_DECREF(fp);
            return nullptr;
        }
        set_attr(fp, "grammar_rules", g);
        set_attr(fp, "grammar_penalty",
                 PyFloat_FromDouble(p.grammar_penalty));
    }
    return fp;
}

// ---------------------------------------------------------------------------
// exported API
// ---------------------------------------------------------------------------

extern "C" {

struct whisper_context_params whisper_context_default_params(void) {
    whisper_context_params p;
    memset(&p, 0, sizeof(p));
    p.use_gpu = true;
    p.gpu_device = 0;
    p.dtw_aheads_preset = WHISPER_AHEADS_NONE;
    p.dtw_n_top = -1;
    return p;
}

static const char * AHEADS_NAMES[] = {
    "none", "n_top_most", "custom", "tiny.en", "tiny", "base.en", "base",
    "small.en", "small", "medium.en", "medium", "large-v1", "large-v2",
    "large-v3", "large-v3-turbo",
};

struct whisper_context * whisper_init_from_file_with_params(
        const char * path_model, struct whisper_context_params params) {
    Gil gil;
    PyObject * cp = call("whisper_context_default_params", nullptr);
    if (!cp) return nullptr;
    set_attr(cp, "dtw_token_timestamps",
             PyBool_FromLong(params.dtw_token_timestamps));
    set_attr(cp, "dtw_aheads_preset",
             PyUnicode_FromString(AHEADS_NAMES[params.dtw_aheads_preset]));
    set_attr(cp, "dtw_n_top", PyLong_FromLong(params.dtw_n_top));
    // the device: use_gpu=false -> cpu (whisper_tpu_torch/capi.py)
    set_attr(cp, "use_gpu", PyBool_FromLong(params.use_gpu));
    set_attr(cp, "gpu_device", PyLong_FromLong(params.gpu_device));

    PyObject * args = Py_BuildValue("(sO)", path_model, cp);
    Py_DECREF(cp);
    PyObject * obj = call("whisper_init_from_file_with_params", args);
    if (!obj) return nullptr;
    whisper_context * ctx = new whisper_context();
    ctx->obj = obj;
    return ctx;
}

struct whisper_context * whisper_init_from_file(const char * path_model) {
    return whisper_init_from_file_with_params(
        path_model, whisper_context_default_params());
}

struct whisper_state * whisper_init_state(struct whisper_context * ctx) {
    Gil gil;
    PyObject * obj = call("whisper_init_state",
                          Py_BuildValue("(O)", ctx->obj));
    if (!obj) return nullptr;
    whisper_state * st = new whisper_state();
    st->obj = obj;
    return st;
}

void whisper_free(struct whisper_context * ctx) {
    if (!ctx) return;
    {
        Gil gil;
        if (ctx->self_state) {
            Py_XDECREF(ctx->self_state->obj);
            delete ctx->self_state;
        }
        Py_XDECREF(ctx->obj);
    }
    delete ctx;
}

void whisper_free_state(struct whisper_state * state) {
    if (!state) return;
    { Gil gil; Py_XDECREF(state->obj); }
    delete state;
}

struct whisper_full_params whisper_full_default_params(
        enum whisper_sampling_strategy strategy) {
    whisper_full_params p;
    memset(&p, 0, sizeof(p));
    p.strategy = strategy;
    p.n_threads = 4;
    p.n_max_text_ctx = 16384;
    p.translate = false;
    p.no_context = true;
    p.single_segment = false;
    p.print_special = false;
    p.print_progress = true;
    p.print_realtime = false;
    p.print_timestamps = true;
    p.thold_pt = 0.01f;
    p.thold_ptsum = 0.01f;
    p.max_len = 0;
    p.max_tokens = 0;
    p.audio_ctx = 0;
    p.language = "en";
    p.suppress_blank = true;
    p.suppress_nst = false;
    p.temperature = 0.0f;
    p.max_initial_ts = 1.0f;
    p.length_penalty = -1.0f;
    p.temperature_inc = 0.2f;
    p.entropy_thold = 2.4f;
    p.logprob_thold = -1.0f;
    p.no_speech_thold = 0.6f;
    p.greedy.best_of = strategy == WHISPER_SAMPLING_GREEDY ? 5 : 5;
    p.beam_search.beam_size = strategy == WHISPER_SAMPLING_BEAM_SEARCH ? 5 : -1;
    p.beam_search.patience = -1.0f;
    p.grammar_penalty = 100.0f;
    return p;
}

int whisper_full(struct whisper_context * ctx,
                 struct whisper_full_params params,
                 const float * samples, int n_samples) {
    Gil gil;
    PyObject * fp = params_to_py(ctx, ctx_self_state(ctx), params);
    PyObject * arr = np_from_f32(samples, n_samples);
    if (!fp || !arr) { Py_XDECREF(fp); Py_XDECREF(arr); return -1; }
    return (int) call_long("whisper_full",
                           Py_BuildValue("(ONN)", ctx->obj, fp, arr));
}

int whisper_full_with_state(struct whisper_context * ctx,
                            struct whisper_state * state,
                            struct whisper_full_params params,
                            const float * samples, int n_samples) {
    Gil gil;
    PyObject * fp = params_to_py(ctx, state, params);
    PyObject * arr = np_from_f32(samples, n_samples);
    if (!fp || !arr) { Py_XDECREF(fp); Py_XDECREF(arr); return -1; }
    return (int) call_long("whisper_full_with_state",
                           Py_BuildValue("(OONN)", ctx->obj, state->obj,
                                         fp, arr));
}

int whisper_full_parallel(struct whisper_context * ctx,
                          struct whisper_full_params params,
                          const float * samples, int n_samples,
                          int n_processors) {
    Gil gil;
    PyObject * fp = params_to_py(ctx, ctx_self_state(ctx), params);
    PyObject * arr = np_from_f32(samples, n_samples);
    if (!fp || !arr) { Py_XDECREF(fp); Py_XDECREF(arr); return -1; }
    PyObject * none = Py_None;
    Py_INCREF(none);
    return (int) call_long("whisper_full_parallel",
                           Py_BuildValue("(ONNNi)", ctx->obj, fp, arr, none,
                                         n_processors));
}

/* By-pointer forwards for FFI bindings that cannot pass structs by
 * value (ruby fiddle, java Panama without a generated descriptor,
 * node FFI).  libwhisper_tpu extensions — not part of the reference
 * whisper.h surface. */
int whisper_full_ref(struct whisper_context * ctx,
                     const struct whisper_full_params * params,
                     const float * samples, int n_samples) {
    if (!params) return -1;
    return whisper_full(ctx, *params, samples, n_samples);
}

int whisper_full_with_state_ref(struct whisper_context * ctx,
                                struct whisper_state * state,
                                const struct whisper_full_params * params,
                                const float * samples, int n_samples) {
    if (!params) return -1;
    return whisper_full_with_state(ctx, state, *params, samples, n_samples);
}

int whisper_full_parallel_ref(struct whisper_context * ctx,
                              const struct whisper_full_params * params,
                              const float * samples, int n_samples,
                              int n_processors) {
    if (!params) return -1;
    return whisper_full_parallel(ctx, *params, samples, n_samples,
                                 n_processors);
}

struct whisper_context * whisper_init_from_file_with_params_ref(
        const char * path_model,
        const struct whisper_context_params * params) {
    if (!params) return nullptr;
    return whisper_init_from_file_with_params(path_model, *params);
}

#define CTX_LONG(name) \
    Gil gil; return (int) call_long(#name, Py_BuildValue("(O)", ctx->obj));

int whisper_full_n_segments(struct whisper_context * ctx) {
    CTX_LONG(whisper_full_n_segments)
}
int whisper_full_n_segments_from_state(struct whisper_state * state) {
    Gil gil;
    return (int) call_long("whisper_full_n_segments_from_state",
                           Py_BuildValue("(O)", state->obj));
}
int whisper_full_lang_id(struct whisper_context * ctx) {
    CTX_LONG(whisper_full_lang_id)
}
int whisper_n_vocab(struct whisper_context * ctx) { CTX_LONG(whisper_n_vocab) }
int whisper_n_text_ctx(struct whisper_context * ctx) { CTX_LONG(whisper_n_text_ctx) }
int whisper_n_audio_ctx(struct whisper_context * ctx) { CTX_LONG(whisper_n_audio_ctx) }
int whisper_is_multilingual(struct whisper_context * ctx) { CTX_LONG(whisper_is_multilingual) }

#define TOKEN_FN(name) \
    whisper_token name(struct whisper_context * ctx) { \
        Gil gil; \
        return (whisper_token) call_long(#name, Py_BuildValue("(O)", ctx->obj)); \
    }
TOKEN_FN(whisper_token_eot)
TOKEN_FN(whisper_token_sot)
TOKEN_FN(whisper_token_solm)
TOKEN_FN(whisper_token_prev)
TOKEN_FN(whisper_token_nosp)
TOKEN_FN(whisper_token_not)
TOKEN_FN(whisper_token_beg)
TOKEN_FN(whisper_token_translate)
TOKEN_FN(whisper_token_transcribe)

whisper_token whisper_token_lang(struct whisper_context * ctx, int lang_id) {
    Gil gil;
    return (whisper_token) call_long(
        "whisper_token_lang", Py_BuildValue("(Oi)", ctx->obj, lang_id));
}

int64_t whisper_full_get_segment_t0(struct whisper_context * ctx, int i) {
    Gil gil;
    return call_long("whisper_full_get_segment_t0",
                     Py_BuildValue("(Oi)", ctx->obj, i));
}
int64_t whisper_full_get_segment_t1(struct whisper_context * ctx, int i) {
    Gil gil;
    return call_long("whisper_full_get_segment_t1",
                     Py_BuildValue("(Oi)", ctx->obj, i));
}
bool whisper_full_get_segment_speaker_turn_next(struct whisper_context * ctx,
                                                int i) {
    Gil gil;
    return call_long("whisper_full_get_segment_speaker_turn_next",
                     Py_BuildValue("(Oi)", ctx->obj, i), 0) != 0;
}
const char * whisper_full_get_segment_text(struct whisper_context * ctx,
                                           int i) {
    Gil gil;
    PyObject * r = call("whisper_full_get_segment_text",
                        Py_BuildValue("(Oi)", ctx->obj, i));
    const char * out = ctx->keep(r);
    Py_XDECREF(r);
    return out;
}
int whisper_full_n_tokens(struct whisper_context * ctx, int i) {
    Gil gil;
    return (int) call_long("whisper_full_n_tokens",
                           Py_BuildValue("(Oi)", ctx->obj, i));
}
const char * whisper_full_get_token_text(struct whisper_context * ctx,
                                         int i, int j) {
    Gil gil;
    PyObject * r = call("whisper_full_get_token_text",
                        Py_BuildValue("(Oii)", ctx->obj, i, j));
    const char * out = ctx->keep(r);
    Py_XDECREF(r);
    return out;
}
whisper_token whisper_full_get_token_id(struct whisper_context * ctx,
                                        int i, int j) {
    Gil gil;
    return (whisper_token) call_long(
        "whisper_full_get_token_id", Py_BuildValue("(Oii)", ctx->obj, i, j));
}
float whisper_full_get_token_p(struct whisper_context * ctx, int i, int j) {
    Gil gil;
    return (float) call_double("whisper_full_get_token_p",
                               Py_BuildValue("(Oii)", ctx->obj, i, j));
}
whisper_token_data whisper_full_get_token_data(struct whisper_context * ctx,
                                               int i, int j) {
    Gil gil;
    whisper_token_data d;
    memset(&d, 0, sizeof(d));
    d.t_dtw = -1;
    PyObject * r = call("whisper_full_get_token_data",
                        Py_BuildValue("(Oii)", ctx->obj, i, j));
    if (!r) return d;
    auto geti = [&](const char * k, long dflt) {
        PyObject * v = PyObject_GetAttrString(r, k);
        long out = v ? PyLong_AsLong(v) : dflt;
        if (PyErr_Occurred()) { PyErr_Clear(); out = dflt; }
        Py_XDECREF(v);
        return out;
    };
    auto getf = [&](const char * k) {
        PyObject * v = PyObject_GetAttrString(r, k);
        double out = v ? PyFloat_AsDouble(v) : 0.0;
        if (PyErr_Occurred()) { PyErr_Clear(); out = 0.0; }
        Py_XDECREF(v);
        return (float) out;
    };
    d.id = (whisper_token) geti("id", 0);
    d.tid = (whisper_token) geti("tid", 0);
    d.p = getf("p");
    d.plog = getf("plog");
    d.pt = getf("pt");
    d.ptsum = getf("ptsum");
    d.t0 = geti("t0", -1);
    d.t1 = geti("t1", -1);
    d.t_dtw = geti("t_dtw", -1);
    d.vlen = getf("vlen");
    Py_DECREF(r);
    return d;
}

int64_t whisper_full_get_segment_t0_from_state(struct whisper_state * s,
                                               int i) {
    Gil gil;
    return call_long("whisper_full_get_segment_t0_from_state",
                     Py_BuildValue("(Oi)", s->obj, i));
}
int64_t whisper_full_get_segment_t1_from_state(struct whisper_state * s,
                                               int i) {
    Gil gil;
    return call_long("whisper_full_get_segment_t1_from_state",
                     Py_BuildValue("(Oi)", s->obj, i));
}
const char * whisper_full_get_segment_text_from_state(
        struct whisper_state * s, int i) {
    Gil gil;
    PyObject * r = call("whisper_full_get_segment_text_from_state",
                        Py_BuildValue("(Oi)", s->obj, i));
    const char * out = s->keep(r);
    Py_XDECREF(r);
    return out;
}

const char * whisper_token_to_str(struct whisper_context * ctx,
                                  whisper_token token) {
    Gil gil;
    PyObject * r = call("whisper_token_to_str",
                        Py_BuildValue("(Oi)", ctx->obj, (int) token));
    const char * out = ctx->keep(r);
    Py_XDECREF(r);
    return out;
}

int whisper_tokenize(struct whisper_context * ctx, const char * text,
                     whisper_token * tokens, int n_max_tokens) {
    Gil gil;
    PyObject * r = PyObject_CallMethod(ctx->obj, "tokenize", "s", text);
    if (!r) { PyErr_Print(); return -1; }
    Py_ssize_t n = PyList_Size(r);
    if ((int) n > n_max_tokens) {
        Py_DECREF(r);
        return -(int) n;
    }
    for (Py_ssize_t i = 0; i < n; i++)
        tokens[i] = (whisper_token) PyLong_AsLong(PyList_GET_ITEM(r, i));
    Py_DECREF(r);
    return (int) n;
}

int whisper_token_count(struct whisper_context * ctx, const char * text) {
    Gil gil;
    return (int) call_long("whisper_token_count",
                           Py_BuildValue("(Os)", ctx->obj, text));
}

int whisper_lang_max_id(void) {
    Gil gil;
    return (int) call_long("whisper_lang_max_id", nullptr);
}
int whisper_lang_id(const char * lang) {
    Gil gil;
    return (int) call_long("whisper_lang_id", Py_BuildValue("(s)", lang));
}
static std::deque<std::string> g_lang_strings;
const char * whisper_lang_str(int id) {
    Gil gil;
    PyObject * r = call("whisper_lang_str", Py_BuildValue("(i)", id));
    if (!r || r == Py_None) { Py_XDECREF(r); return nullptr; }
    const char * u = PyUnicode_AsUTF8(r);
    g_lang_strings.push_back(u ? u : "");
    Py_DECREF(r);
    return g_lang_strings.back().c_str();
}
const char * whisper_lang_str_full(int id) {
    Gil gil;
    PyObject * r = call("whisper_lang_str_full", Py_BuildValue("(i)", id));
    if (!r || r == Py_None) { Py_XDECREF(r); return nullptr; }
    const char * u = PyUnicode_AsUTF8(r);
    g_lang_strings.push_back(u ? u : "");
    Py_DECREF(r);
    return g_lang_strings.back().c_str();
}

int whisper_pcm_to_mel(struct whisper_context * ctx, const float * samples,
                       int n_samples, int n_threads) {
    Gil gil;
    PyObject * arr = np_from_f32(samples, n_samples);
    if (!arr) return -1;
    return (int) call_long("whisper_pcm_to_mel",
                           Py_BuildValue("(ONOi)", ctx->obj, arr,
                                         Py_None, n_threads));
}

void whisper_print_timings(struct whisper_context * ctx) {
    Gil gil;
    PyObject * r = call("whisper_print_timings",
                        Py_BuildValue("(O)", ctx->obj));
    Py_XDECREF(r);
}
void whisper_reset_timings(struct whisper_context * ctx) {
    Gil gil;
    PyObject * r = call("whisper_reset_timings",
                        Py_BuildValue("(O)", ctx->obj));
    Py_XDECREF(r);
}
const char * whisper_print_system_info(void) {
    Gil gil;
    static std::string info;
    PyObject * r = call("whisper_print_system_info", nullptr);
    if (r) {
        info = PyUnicode_AsUTF8(r);
        Py_DECREF(r);
    }
    return info.c_str();
}
const char * whisper_version(void) {
    return "whisper_tpu-1.7.5-compat";
}


// ---------------------------------------------------------------------------
// whisper.h completion: init variants, raw encode/decode, from_state
// accessors, logits, timings, model introspection, log callback
// ---------------------------------------------------------------------------

static PyObject * ctx_params_to_py(struct whisper_context_params params) {
    PyObject * cp = call("whisper_context_default_params", nullptr);
    if (!cp) return nullptr;
    set_attr(cp, "dtw_token_timestamps",
             PyBool_FromLong(params.dtw_token_timestamps));
    set_attr(cp, "dtw_aheads_preset",
             PyUnicode_FromString(AHEADS_NAMES[params.dtw_aheads_preset]));
    set_attr(cp, "dtw_n_top", PyLong_FromLong(params.dtw_n_top));
    // the device: use_gpu=false -> cpu (whisper_tpu_torch/capi.py)
    set_attr(cp, "use_gpu", PyBool_FromLong(params.use_gpu));
    set_attr(cp, "gpu_device", PyLong_FromLong(params.gpu_device));
    return cp;
}

static struct whisper_context * box_ctx(PyObject * obj) {
    if (!obj) return nullptr;
    whisper_context * ctx = new whisper_context();
    ctx->obj = obj;
    return ctx;
}

static PyObject * drain_loader(struct whisper_model_loader * loader) {
    // pull the whole model through the C loader callbacks into one bytes
    std::string data;
    char buf[1 << 16];
    while (!loader->eof(loader->context)) {
        size_t n = loader->read(loader->context, buf, sizeof(buf));
        if (n == 0) break;
        data.append(buf, n);
    }
    if (loader->close) loader->close(loader->context);
    return PyBytes_FromStringAndSize(data.data(),
                                     (Py_ssize_t) data.size());
}

static struct whisper_context * init_buffer_impl(
        const char * fn, void * buffer, size_t buffer_size,
        struct whisper_context_params params) {
    Gil gil;
    PyObject * cp = ctx_params_to_py(params);
    if (!cp) return nullptr;
    PyObject * args = Py_BuildValue("(y#N)", (const char *) buffer,
                                    (Py_ssize_t) buffer_size, cp);
    return box_ctx(call(fn, args));
}

struct whisper_context * whisper_init_from_buffer_with_params(
        void * buffer, size_t buffer_size,
        struct whisper_context_params params) {
    return init_buffer_impl("whisper_init_from_buffer_with_params",
                            buffer, buffer_size, params);
}
struct whisper_context * whisper_init_from_buffer_with_params_no_state(
        void * buffer, size_t buffer_size,
        struct whisper_context_params params) {
    return init_buffer_impl("whisper_init_from_buffer_with_params_no_state",
                            buffer, buffer_size, params);
}
struct whisper_context * whisper_init_from_buffer(void * buffer,
                                                  size_t buffer_size) {
    return whisper_init_from_buffer_with_params(
        buffer, buffer_size, whisper_context_default_params());
}
struct whisper_context * whisper_init_from_buffer_no_state(
        void * buffer, size_t buffer_size) {
    return whisper_init_from_buffer_with_params_no_state(
        buffer, buffer_size, whisper_context_default_params());
}

struct whisper_context * whisper_init_with_params(
        struct whisper_model_loader * loader,
        struct whisper_context_params params) {
    Gil gil;
    PyObject * data = drain_loader(loader);
    PyObject * cp = ctx_params_to_py(params);
    if (!data || !cp) { Py_XDECREF(data); Py_XDECREF(cp); return nullptr; }
    return box_ctx(call("whisper_init_from_buffer_with_params",
                        Py_BuildValue("(NN)", data, cp)));
}
struct whisper_context * whisper_init_with_params_no_state(
        struct whisper_model_loader * loader,
        struct whisper_context_params params) {
    Gil gil;
    PyObject * data = drain_loader(loader);
    PyObject * cp = ctx_params_to_py(params);
    if (!data || !cp) { Py_XDECREF(data); Py_XDECREF(cp); return nullptr; }
    return box_ctx(call("whisper_init_from_buffer_with_params_no_state",
                        Py_BuildValue("(NN)", data, cp)));
}
struct whisper_context * whisper_init(struct whisper_model_loader * loader) {
    return whisper_init_with_params(loader,
                                    whisper_context_default_params());
}
struct whisper_context * whisper_init_no_state(
        struct whisper_model_loader * loader) {
    return whisper_init_with_params_no_state(
        loader, whisper_context_default_params());
}
struct whisper_context * whisper_init_from_file_no_state(
        const char * path_model) {
    Gil gil;
    PyObject * cp = ctx_params_to_py(whisper_context_default_params());
    if (!cp) return nullptr;
    return box_ctx(call("whisper_init_from_file_with_params_no_state",
                        Py_BuildValue("(sN)", path_model, cp)));
}
struct whisper_context * whisper_init_from_file_with_params_no_state(
        const char * path_model, struct whisper_context_params params) {
    Gil gil;
    PyObject * cp = ctx_params_to_py(params);
    if (!cp) return nullptr;
    return box_ctx(call("whisper_init_from_file_with_params_no_state",
                        Py_BuildValue("(sN)", path_model, cp)));
}

int whisper_ctx_init_openvino_encoder_with_state(
        struct whisper_context * ctx, struct whisper_state * state,
        const char * model_path, const char * device,
        const char * cache_dir) {
    Gil gil;
    return (int) call_long(
        "whisper_ctx_init_openvino_encoder_with_state",
        Py_BuildValue("(OOsss)", ctx->obj, state ? state->obj : Py_None,
                      model_path ? model_path : "",
                      device ? device : "", cache_dir ? cache_dir : ""));
}
int whisper_ctx_init_openvino_encoder(
        struct whisper_context * ctx, const char * model_path,
        const char * device, const char * cache_dir) {
    return whisper_ctx_init_openvino_encoder_with_state(
        ctx, nullptr, model_path, device, cache_dir);
}

struct whisper_context_params * whisper_context_default_params_by_ref(void) {
    auto * p = (struct whisper_context_params *)
        malloc(sizeof(struct whisper_context_params));
    *p = whisper_context_default_params();
    return p;
}
struct whisper_full_params * whisper_full_default_params_by_ref(
        enum whisper_sampling_strategy strategy) {
    auto * p = (struct whisper_full_params *)
        malloc(sizeof(struct whisper_full_params));
    *p = whisper_full_default_params(strategy);
    return p;
}
void whisper_free_params(struct whisper_full_params * params) { free(params); }
void whisper_free_context_params(struct whisper_context_params * params) {
    free(params);
}

// ---- raw mel / encode / decode --------------------------------------------

int whisper_pcm_to_mel_with_state(struct whisper_context * ctx,
                                  struct whisper_state * state,
                                  const float * samples, int n_samples,
                                  int n_threads) {
    Gil gil;
    PyObject * arr = np_from_f32(samples, n_samples);
    if (!arr) return -1;
    return (int) call_long("whisper_pcm_to_mel_with_state",
                           Py_BuildValue("(OONii)", ctx->obj, state->obj,
                                         arr, n_samples, n_threads));
}
int whisper_set_mel(struct whisper_context * ctx, const float * data,
                    int n_len, int n_mel) {
    Gil gil;
    PyObject * arr = np_from_f32(data, n_len * n_mel);
    if (!arr) return -1;
    return (int) call_long("whisper_set_mel",
                           Py_BuildValue("(ONii)", ctx->obj, arr,
                                         n_len, n_mel));
}
int whisper_set_mel_with_state(struct whisper_context * ctx,
                               struct whisper_state * state,
                               const float * data, int n_len, int n_mel) {
    Gil gil;
    PyObject * arr = np_from_f32(data, n_len * n_mel);
    if (!arr) return -1;
    return (int) call_long("whisper_set_mel_with_state",
                           Py_BuildValue("(OONii)", ctx->obj, state->obj,
                                         arr, n_len, n_mel));
}
int whisper_encode(struct whisper_context * ctx, int offset, int n_threads) {
    Gil gil;
    return (int) call_long("whisper_encode",
                           Py_BuildValue("(Oii)", ctx->obj, offset,
                                         n_threads));
}
int whisper_encode_with_state(struct whisper_context * ctx,
                              struct whisper_state * state, int offset,
                              int n_threads) {
    Gil gil;
    return (int) call_long("whisper_encode_with_state",
                           Py_BuildValue("(OOii)", ctx->obj, state->obj,
                                         offset, n_threads));
}

static PyObject * token_list(const whisper_token * tokens, int n) {
    PyObject * lst = PyList_New(n);
    for (int i = 0; i < n; i++)
        PyList_SET_ITEM(lst, i, PyLong_FromLong(tokens[i]));
    return lst;
}

int whisper_decode(struct whisper_context * ctx,
                   const whisper_token * tokens, int n_tokens, int n_past,
                   int n_threads) {
    Gil gil;
    return (int) call_long("whisper_decode",
                           Py_BuildValue("(ONiii)", ctx->obj,
                                         token_list(tokens, n_tokens),
                                         n_tokens, n_past, n_threads));
}
int whisper_decode_with_state(struct whisper_context * ctx,
                              struct whisper_state * state,
                              const whisper_token * tokens, int n_tokens,
                              int n_past, int n_threads) {
    Gil gil;
    return (int) call_long("whisper_decode_with_state",
                           Py_BuildValue("(OONiii)", ctx->obj, state->obj,
                                         token_list(tokens, n_tokens),
                                         n_tokens, n_past, n_threads));
}

static float * logits_into(PyObject * r, std::vector<float> & buf) {
    // r: float32 numpy array (n_tokens, n_vocab) -> flat copy
    if (!r) return nullptr;
    PyObject * b = PyObject_CallMethod(r, "tobytes", nullptr);
    Py_DECREF(r);
    if (!b) { PyErr_Print(); return nullptr; }
    char * raw; Py_ssize_t len;
    if (PyBytes_AsStringAndSize(b, &raw, &len) != 0) {
        Py_DECREF(b); return nullptr;
    }
    buf.resize((size_t) len / sizeof(float));
    memcpy(buf.data(), raw, (size_t) len);
    Py_DECREF(b);
    return buf.data();
}

float * whisper_get_logits(struct whisper_context * ctx) {
    Gil gil;
    return logits_into(call("whisper_get_logits",
                            Py_BuildValue("(O)", ctx->obj)),
                       ctx->logits_buf);
}
float * whisper_get_logits_from_state(struct whisper_state * state) {
    Gil gil;
    return logits_into(call("whisper_get_logits_from_state",
                            Py_BuildValue("(O)", state->obj)),
                       state->logits_buf);
}

int whisper_n_len_from_state(struct whisper_state * state) {
    Gil gil;
    return (int) call_long("whisper_n_len_from_state",
                           Py_BuildValue("(O)", state->obj));
}

int whisper_lang_auto_detect_with_state(struct whisper_context * ctx,
                                        struct whisper_state * state,
                                        int offset_ms, int n_threads,
                                        float * lang_probs) {
    Gil gil;
    int n = whisper_lang_max_id() + 1;
    PyObject * probs;
    if (lang_probs) {
        probs = PyList_New(n);
        for (int i = 0; i < n; i++)
            PyList_SET_ITEM(probs, i, PyFloat_FromDouble(0.0));
    } else {
        probs = Py_None;
        Py_INCREF(probs);
    }
    PyObject * args = state
        ? Py_BuildValue("(OOiiO)", ctx->obj, state->obj, offset_ms,
                        n_threads, probs)
        : Py_BuildValue("(OiiO)", ctx->obj, offset_ms, n_threads, probs);
    long lid = call_long(state ? "whisper_lang_auto_detect_with_state"
                               : "whisper_lang_auto_detect", args);
    if (lang_probs && PyList_Check(probs)) {
        for (int i = 0; i < n && i < (int) PyList_GET_SIZE(probs); i++)
            lang_probs[i] =
                (float) PyFloat_AsDouble(PyList_GET_ITEM(probs, i));
        if (PyErr_Occurred()) PyErr_Clear();
    }
    Py_DECREF(probs);
    return (int) lid;
}
int whisper_lang_auto_detect(struct whisper_context * ctx, int offset_ms,
                             int n_threads, float * lang_probs) {
    return whisper_lang_auto_detect_with_state(ctx, nullptr, offset_ms,
                                               n_threads, lang_probs);
}

// ---- from_state result accessors ------------------------------------------

int whisper_full_lang_id_from_state(struct whisper_state * state) {
    Gil gil;
    return (int) call_long("whisper_full_lang_id_from_state",
                           Py_BuildValue("(O)", state->obj));
}
bool whisper_full_get_segment_speaker_turn_next_from_state(
        struct whisper_state * state, int i_segment) {
    Gil gil;
    return call_long("whisper_full_get_segment_speaker_turn_next_from_state",
                     Py_BuildValue("(Oi)", state->obj, i_segment), 0) != 0;
}
float whisper_full_get_segment_no_speech_prob(
        struct whisper_context * ctx, int i_segment) {
    Gil gil;
    return (float) call_double(
        "whisper_full_get_segment_no_speech_prob",
        Py_BuildValue("(Oi)", ctx->obj, i_segment));
}
float whisper_full_get_segment_no_speech_prob_from_state(
        struct whisper_state * state, int i_segment) {
    Gil gil;
    return (float) call_double(
        "whisper_full_get_segment_no_speech_prob_from_state",
        Py_BuildValue("(Oi)", state->obj, i_segment));
}
int whisper_full_n_tokens_from_state(struct whisper_state * state,
                                     int i_segment) {
    Gil gil;
    return (int) call_long("whisper_full_n_tokens_from_state",
                           Py_BuildValue("(Oi)", state->obj, i_segment));
}
const char * whisper_full_get_token_text_from_state(
        struct whisper_context * ctx, struct whisper_state * state,
        int i_segment, int i_token) {
    Gil gil;
    PyObject * r = call("whisper_full_get_token_text_from_state",
                        Py_BuildValue("(OOii)", ctx->obj, state->obj,
                                      i_segment, i_token));
    const char * out = state->keep(r);
    Py_XDECREF(r);
    return out;
}
whisper_token whisper_full_get_token_id_from_state(
        struct whisper_state * state, int i_segment, int i_token) {
    Gil gil;
    return (whisper_token) call_long(
        "whisper_full_get_token_id_from_state",
        Py_BuildValue("(Oii)", state->obj, i_segment, i_token));
}
float whisper_full_get_token_p_from_state(struct whisper_state * state,
                                          int i_segment, int i_token) {
    Gil gil;
    return (float) call_double(
        "whisper_full_get_token_p_from_state",
        Py_BuildValue("(Oii)", state->obj, i_segment, i_token));
}

static whisper_token_data token_data_from_py(PyObject * r) {
    whisper_token_data d;
    memset(&d, 0, sizeof(d));
    d.t_dtw = -1;
    if (!r) return d;
    auto geti = [&](const char * k, long dflt) {
        PyObject * v = PyObject_GetAttrString(r, k);
        long out = v ? PyLong_AsLong(v) : dflt;
        if (PyErr_Occurred()) { PyErr_Clear(); out = dflt; }
        Py_XDECREF(v);
        return out;
    };
    auto getf = [&](const char * k) {
        PyObject * v = PyObject_GetAttrString(r, k);
        double out = v ? PyFloat_AsDouble(v) : 0.0;
        if (PyErr_Occurred()) { PyErr_Clear(); out = 0.0; }
        Py_XDECREF(v);
        return (float) out;
    };
    d.id = (whisper_token) geti("id", 0);
    d.tid = (whisper_token) geti("tid", 0);
    d.p = getf("p");
    d.plog = getf("plog");
    d.pt = getf("pt");
    d.ptsum = getf("ptsum");
    d.t0 = geti("t0", -1);
    d.t1 = geti("t1", -1);
    d.t_dtw = geti("t_dtw", -1);
    d.vlen = getf("vlen");
    Py_DECREF(r);
    return d;
}

whisper_token_data whisper_full_get_token_data_from_state(
        struct whisper_state * state, int i_segment, int i_token) {
    Gil gil;
    return token_data_from_py(
        call("whisper_full_get_token_data_from_state",
             Py_BuildValue("(Oii)", state->obj, i_segment, i_token)));
}

// ---- model introspection ---------------------------------------------------

#define MODEL_INT(name) \
    int name(struct whisper_context * ctx) { \
        Gil gil; \
        return (int) call_long(#name, Py_BuildValue("(O)", ctx->obj)); \
    }
MODEL_INT(whisper_model_n_vocab)
MODEL_INT(whisper_model_n_audio_ctx)
MODEL_INT(whisper_model_n_audio_state)
MODEL_INT(whisper_model_n_audio_head)
MODEL_INT(whisper_model_n_audio_layer)
MODEL_INT(whisper_model_n_text_ctx)
MODEL_INT(whisper_model_n_text_state)
MODEL_INT(whisper_model_n_text_head)
MODEL_INT(whisper_model_n_text_layer)
MODEL_INT(whisper_model_n_mels)
MODEL_INT(whisper_model_ftype)
MODEL_INT(whisper_n_len)

const char * whisper_model_type_readable(struct whisper_context * ctx) {
    Gil gil;
    PyObject * r = call("whisper_model_type_readable",
                        Py_BuildValue("(O)", ctx->obj));
    const char * out = ctx->keep(r);
    Py_XDECREF(r);
    return out;
}
int whisper_model_type(struct whisper_context * ctx) {
    // e_model mapping (reference: src/whisper.cpp:233-241)
    const char * t = whisper_model_type_readable(ctx);
    if (strncmp(t, "tiny", 4) == 0)   return 1;
    if (strncmp(t, "base", 4) == 0)   return 2;
    if (strncmp(t, "small", 5) == 0)  return 3;
    if (strncmp(t, "medium", 6) == 0) return 4;
    if (strncmp(t, "large", 5) == 0)  return 5;
    return 0;
}

struct whisper_timings * whisper_get_timings(struct whisper_context * ctx) {
    Gil gil;
    PyObject * r = call("whisper_get_timings",
                        Py_BuildValue("(O)", ctx->obj));
    auto & box = ctx->timings_box;
    memset(&box, 0, sizeof(box));
    if (r && PyDict_Check(r)) {
        auto get = [&](const char * k) {
            PyObject * v = PyDict_GetItemString(r, k);   // borrowed
            return v ? (float) PyFloat_AsDouble(v) : 0.0f;
        };
        box.sample_ms = get("sample_ms");
        box.encode_ms = get("encode_ms");
        box.decode_ms = get("decode_ms");
        box.batchd_ms = get("batchd_ms");
        box.prompt_ms = get("prompt_ms");
    }
    Py_XDECREF(r);
    return (struct whisper_timings *) &box;
}

// ---- bench strings ---------------------------------------------------------

static std::deque<std::string> g_bench_strings;
static const char * bench_str(const char * fn, int n_threads) {
    Gil gil;
    PyObject * r = call(fn, Py_BuildValue("(i)", n_threads));
    const char * u = r ? PyUnicode_AsUTF8(r) : nullptr;
    g_bench_strings.push_back(u ? u : "");
    Py_XDECREF(r);
    return g_bench_strings.back().c_str();
}
const char * whisper_bench_memcpy_str(int n_threads) {
    return bench_str("whisper_bench_memcpy_str", n_threads);
}
const char * whisper_bench_ggml_mul_mat_str(int n_threads) {
    return bench_str("whisper_bench_ggml_mul_mat_str", n_threads);
}
int whisper_bench_memcpy(int n_threads) {
    Gil gil;
    return (int) call_long("whisper_bench_memcpy",
                           Py_BuildValue("(i)", n_threads), 0);
}
int whisper_bench_ggml_mul_mat(int n_threads) {
    Gil gil;
    return (int) call_long("whisper_bench_ggml_mul_mat",
                           Py_BuildValue("(i)", n_threads), 0);
}

// ---- log callback ----------------------------------------------------------

static whisper_tpu_log_callback g_log_cb = nullptr;
static void * g_log_ud = nullptr;

static PyObject * log_trampoline(PyObject * self, PyObject * args) {
    int level; const char * text;
    if (PyArg_ParseTuple(args, "is", &level, &text) && g_log_cb)
        g_log_cb(level, text, g_log_ud);
    Py_RETURN_NONE;
}
static PyMethodDef log_trampoline_def = {
    "wtpu_log_trampoline", log_trampoline, METH_VARARGS, nullptr};

void whisper_log_set(whisper_tpu_log_callback log_callback,
                     void * user_data) {
    Gil gil;
    g_log_cb = log_callback;
    g_log_ud = user_data;
    PyObject * cb;
    if (log_callback) {
        cb = PyCFunction_New(&log_trampoline_def, nullptr);
    } else {
        cb = Py_None;
        Py_INCREF(cb);
    }
    PyObject * r = call("whisper_log_set", Py_BuildValue("(N)", cb));
    Py_XDECREF(r);
}

}  // extern "C"
