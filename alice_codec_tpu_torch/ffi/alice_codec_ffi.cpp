// C ABI for ALICE-Codec (PyTorch/CUDA port) — the 20-function surface of
// the reference
// (reference: src/ffi.rs:16-315), consumed by the Unity (bindings/unity)
// and UE5 (bindings/ue5) wrappers.
//
// Split of work:
//   * Wavelet1D (fns 1-6) and PSNR (fn 17): implemented natively here —
//     exact integer lifting per the spec (reference src/wavelet.rs:133-217),
//     including the i64 delta arithmetic.
//   * Encoder/decoder/chunk (fns 7-16): bridged into the Python package
//     via embedded CPython, so host apps (game engines) drive the real CUDA
//     pipeline.  When the shim is loaded *from* a Python process, the
//     existing interpreter is used (PyGILState); otherwise Py_Initialize
//     runs on first use.
//
// Build: see alice_codec_tpu_torch/ffi/__init__.py (g++ -shared -fPIC
// -I<python-include> -lpython3.X).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <vector>

// ── Native Wavelet1D (reference src/wavelet.rs) ─────────────────

namespace {

struct LiftingStep {
    int32_t coeff;
    bool predict;
};

struct Wavelet1D {
    std::vector<LiftingStep> steps;
};

Wavelet1D* make_wavelet(std::initializer_list<LiftingStep> steps) {
    auto* w = new Wavelet1D();
    w->steps.assign(steps);
    return w;
}

void lift_predict(int32_t* s, int64_t n, int32_t coeff) {
    int64_t half = n / 2;
    for (int64_t i = 0; i < half; ++i) {
        int64_t el = s[i * 2];
        int64_t er = (i * 2 + 2 < n) ? s[i * 2 + 2] : s[i * 2];
        int64_t delta = ((el + er) * coeff + 4096) >> 13;
        s[i * 2 + 1] += static_cast<int32_t>(delta);
    }
}

void lift_update(int32_t* s, int64_t n, int32_t coeff) {
    int64_t half = n / 2;
    for (int64_t i = 0; i < half; ++i) {
        int64_t ol = (i > 0) ? s[i * 2 - 1] : s[1];
        int64_t orr = s[i * 2 + 1];
        int64_t delta = ((ol + orr) * coeff + 4096) >> 13;
        s[i * 2] += static_cast<int32_t>(delta);
    }
}

void wavelet_forward(const Wavelet1D* w, int32_t* data, int64_t n) {
    if (n < 2) return;
    for (const auto& st : w->steps) {
        if (st.predict) lift_predict(data, n, st.coeff);
        else lift_update(data, n, st.coeff);
    }
    // deinterleave (reference src/wavelet.rs:220-233, incl. odd-n quirk)
    int64_t half = n / 2;
    std::vector<int32_t> temp(n, 0);
    for (int64_t i = 0; i < half; ++i) {
        temp[i] = data[i * 2];
        temp[half + i] = data[i * 2 + 1];
    }
    std::memcpy(data, temp.data(), n * sizeof(int32_t));
}

void wavelet_inverse(const Wavelet1D* w, int32_t* data, int64_t n) {
    if (n < 2) return;
    int64_t half = n / 2;
    std::vector<int32_t> temp(n, 0);
    for (int64_t i = 0; i < half; ++i) {
        temp[i * 2] = data[i];
        temp[i * 2 + 1] = data[half + i];
    }
    std::memcpy(data, temp.data(), n * sizeof(int32_t));
    for (auto it = w->steps.rbegin(); it != w->steps.rend(); ++it) {
        if (it->predict) lift_predict(data, n, -it->coeff);
        else lift_update(data, n, -it->coeff);
    }
}

// ── Embedded Python bridge ──────────────────────────────────────

bool g_we_initialized = false;

class GilGuard {
   public:
    GilGuard() {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
            g_we_initialized = true;
        }
        state_ = PyGILState_Ensure();
    }
    ~GilGuard() { PyGILState_Release(state_); }

   private:
    PyGILState_STATE state_;
};

PyObject* helpers_module() {
    static PyObject* mod = nullptr;
    if (!mod) {
        mod = PyImport_ImportModule("alice_codec_tpu_torch.ffi.helpers");
        if (!mod) PyErr_Clear();
    }
    return mod;
}

// Opaque chunk handle: owns a Python EncodedChunk + cached dims.
struct ChunkHandle {
    PyObject* obj;
    uint32_t width, height, frames;
};

struct EncoderHandle {
    uint8_t quality;
};

ChunkHandle* wrap_chunk(PyObject* obj) {
    if (!obj || obj == Py_None) {
        Py_XDECREF(obj);
        return nullptr;
    }
    GilGuard gil;
    auto* h = new ChunkHandle{obj, 0, 0, 0};
    PyObject* mod = helpers_module();
    if (mod) {
        PyObject* dims = PyObject_CallMethod(mod, "chunk_dims", "O", obj);
        if (dims) {
            h->width = static_cast<uint32_t>(
                PyLong_AsUnsignedLong(PyTuple_GetItem(dims, 0)));
            h->height = static_cast<uint32_t>(
                PyLong_AsUnsignedLong(PyTuple_GetItem(dims, 1)));
            h->frames = static_cast<uint32_t>(
                PyLong_AsUnsignedLong(PyTuple_GetItem(dims, 2)));
            Py_DECREF(dims);
        } else {
            PyErr_Clear();
        }
    }
    return h;
}

uint8_t* bytes_to_buffer(PyObject* bytes, uint32_t* out_len) {
    if (!bytes || bytes == Py_None) {
        Py_XDECREF(bytes);
        return nullptr;
    }
    char* data = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(bytes, &data, &len) != 0) {
        PyErr_Clear();
        Py_DECREF(bytes);
        return nullptr;
    }
    auto* out = static_cast<uint8_t*>(std::malloc(len ? len : 1));
    std::memcpy(out, data, len);
    *out_len = static_cast<uint32_t>(len);
    Py_DECREF(bytes);
    return out;
}

}  // namespace

extern "C" {

// ── Wavelet1D (6 functions, reference src/ffi.rs:16-86) ─────────

Wavelet1D* alice_codec_wavelet1d_haar() {
    return make_wavelet({{-4096, true}, {2048, false}});
}

Wavelet1D* alice_codec_wavelet1d_cdf53() {
    return make_wavelet({{-4096, true}, {1024, false}});
}

Wavelet1D* alice_codec_wavelet1d_cdf97() {
    return make_wavelet(
        {{-6497, true}, {-217, false}, {3616, true}, {1817, false}});
}

void alice_codec_wavelet1d_destroy(Wavelet1D* ptr) { delete ptr; }

void alice_codec_wavelet1d_forward(const Wavelet1D* wavelet, int32_t* data,
                                   uint32_t len) {
    if (!wavelet || !data || len < 2) return;
    wavelet_forward(wavelet, data, len);
}

void alice_codec_wavelet1d_inverse(const Wavelet1D* wavelet, int32_t* data,
                                   uint32_t len) {
    if (!wavelet || !data || len < 2) return;
    wavelet_inverse(wavelet, data, len);
}

// ── FrameEncoder (3 functions, reference src/ffi.rs:92-133) ─────

EncoderHandle* alice_codec_encoder_create(uint8_t quality) {
    return new EncoderHandle{quality};
}

void alice_codec_encoder_destroy(EncoderHandle* ptr) { delete ptr; }

ChunkHandle* alice_codec_encode(const EncoderHandle* encoder,
                                const uint8_t* rgb_data, uint32_t rgb_len,
                                uint32_t width, uint32_t height,
                                uint32_t frames) {
    if (!encoder || !rgb_data) return nullptr;
    GilGuard gil;
    PyObject* mod = helpers_module();
    if (!mod) return nullptr;
    PyObject* obj = PyObject_CallMethod(
        mod, "encode", "iy#III", static_cast<int>(encoder->quality),
        reinterpret_cast<const char*>(rgb_data),
        static_cast<Py_ssize_t>(rgb_len), width, height, frames);
    if (!obj) {
        PyErr_Clear();
        return nullptr;
    }
    return wrap_chunk(obj);
}

// ── Decode (1 function, reference src/ffi.rs:145-161) ───────────

uint8_t* alice_codec_decode(const ChunkHandle* chunk, uint32_t* out_len) {
    if (!chunk || !out_len) return nullptr;
    GilGuard gil;
    PyObject* mod = helpers_module();
    if (!mod) return nullptr;
    PyObject* bytes = PyObject_CallMethod(mod, "decode", "O", chunk->obj);
    if (!bytes) {
        PyErr_Clear();
        return nullptr;
    }
    return bytes_to_buffer(bytes, out_len);
}

// ── EncodedChunk (6 functions, reference src/ffi.rs:171-260) ────

void alice_codec_chunk_destroy(ChunkHandle* ptr) {
    if (!ptr) return;
    {
        GilGuard gil;
        Py_XDECREF(ptr->obj);
    }
    delete ptr;
}

uint8_t* alice_codec_chunk_to_bytes(const ChunkHandle* chunk,
                                    uint32_t* out_len) {
    if (!chunk || !out_len) return nullptr;
    GilGuard gil;
    PyObject* mod = helpers_module();
    if (!mod) return nullptr;
    PyObject* bytes =
        PyObject_CallMethod(mod, "chunk_to_bytes", "O", chunk->obj);
    if (!bytes) {
        PyErr_Clear();
        return nullptr;
    }
    return bytes_to_buffer(bytes, out_len);
}

ChunkHandle* alice_codec_chunk_from_bytes(const uint8_t* data, uint32_t len) {
    if (!data) return nullptr;
    GilGuard gil;
    PyObject* mod = helpers_module();
    if (!mod) return nullptr;
    PyObject* obj = PyObject_CallMethod(
        mod, "chunk_from_bytes", "y#", reinterpret_cast<const char*>(data),
        static_cast<Py_ssize_t>(len));
    if (!obj) {
        PyErr_Clear();
        return nullptr;
    }
    return wrap_chunk(obj);
}

uint32_t alice_codec_chunk_width(const ChunkHandle* chunk) {
    return chunk ? chunk->width : 0;
}

uint32_t alice_codec_chunk_height(const ChunkHandle* chunk) {
    return chunk ? chunk->height : 0;
}

uint32_t alice_codec_chunk_frames(const ChunkHandle* chunk) {
    return chunk ? chunk->frames : 0;
}

// ── Metrics (1 function, reference src/ffi.rs:270-278) ──────────

double alice_codec_psnr(const uint8_t* a, const uint8_t* b, uint32_t len) {
    if (!a || !b) return -1.0;
    if (len == 0) return HUGE_VAL;
    double sum = 0.0;
    for (uint32_t i = 0; i < len; ++i) {
        double diff = static_cast<double>(a[i]) - static_cast<double>(b[i]);
        sum += diff * diff;
    }
    double mse = sum / len;
    if (mse == 0.0) return HUGE_VAL;
    return 10.0 * std::log10(255.0 * 255.0 / mse);
}

// ── Utility (3 functions, reference src/ffi.rs:288-315) ─────────

void alice_codec_data_free(uint8_t* ptr, uint32_t len) {
    (void)len;
    std::free(ptr);
}

void alice_codec_string_free(char* s) { std::free(s); }

char* alice_codec_version() {
    const char* v = "0.1.2";
    char* out = static_cast<char*>(std::malloc(std::strlen(v) + 1));
    std::strcpy(out, v);
    return out;
}

}  // extern "C"
