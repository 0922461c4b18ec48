/*
 * Native ingest runtime: lock-free SPSC IQ ring buffer + sample-format
 * converters (the data-loader tier of the framework).
 *
 * Role of the reference's sample transport: OverflowableTransferQueue's
 * drop-on-overflow semantics (sample/buffer/OverflowableReusableBuffer
 * TransferQueue.java:20-44) and the USB tuner sample converters
 * (source/tuner/usb/converter: 8-bit RTL2832, packed/unpacked 12-bit
 * Airspy, 16-bit). The ring feeds the device pipeline from a producer
 * thread (file replay or SDR driver) without Python-level locking; both
 * sides run with the GIL released via ctypes.
 *
 * Build: make (native/Makefile) -> libiqruntime.so, loaded via ctypes
 * (sdrtrunk_jax/io/native.py) with a NumPy fallback when unavailable.
 */
#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct IqRing {
    float *data;              /* interleaved I/Q pairs */
    size_t capacity;          /* in complex samples */
    _Atomic size_t head;      /* write position (complex samples) */
    _Atomic size_t tail;      /* read position */
    _Atomic size_t dropped;   /* complex samples dropped on overflow */
    _Atomic int overflow;     /* sticky overflow flag w/ reset threshold */
    size_t reset_threshold;   /* clear overflow when backlog below this */
} IqRing;

IqRing *iq_ring_create(size_t capacity_samples, size_t reset_threshold)
{
    IqRing *r = (IqRing *)calloc(1, sizeof(IqRing));
    if (!r) return NULL;
    r->data = (float *)malloc(sizeof(float) * 2 * capacity_samples);
    if (!r->data) { free(r); return NULL; }
    r->capacity = capacity_samples;
    r->reset_threshold = reset_threshold;
    return r;
}

void iq_ring_destroy(IqRing *r)
{
    if (r) { free(r->data); free(r); }
}

static size_t ring_used(const IqRing *r)
{
    size_t h = atomic_load_explicit(&((IqRing *)r)->head,
                                    memory_order_acquire);
    size_t t = atomic_load_explicit(&((IqRing *)r)->tail,
                                    memory_order_acquire);
    return h - t;
}

size_t iq_ring_available(IqRing *r) { return ring_used(r); }
size_t iq_ring_capacity(IqRing *r) { return r->capacity; }
size_t iq_ring_dropped(IqRing *r)
{
    return atomic_load_explicit(&r->dropped, memory_order_relaxed);
}
int iq_ring_overflowed(IqRing *r)
{
    return atomic_load_explicit(&r->overflow, memory_order_relaxed);
}

/* producer side: write n complex samples; drops the excess when full
 * (drop + overflow-flag semantics of the reference queue) */
size_t iq_ring_write(IqRing *r, const float *iq, size_t n)
{
    size_t used = ring_used(r);
    size_t space = r->capacity - used;
    size_t todo = n <= space ? n : space;
    if (todo < n) {
        atomic_fetch_add_explicit(&r->dropped, n - todo,
                                  memory_order_relaxed);
        atomic_store_explicit(&r->overflow, 1, memory_order_relaxed);
    }
    size_t h = atomic_load_explicit(&r->head, memory_order_relaxed);
    for (size_t k = 0; k < todo;) {
        size_t pos = (h + k) % r->capacity;
        size_t run = r->capacity - pos;
        if (run > todo - k) run = todo - k;
        memcpy(r->data + 2 * pos, iq + 2 * k, sizeof(float) * 2 * run);
        k += run;
    }
    atomic_store_explicit(&r->head, h + todo, memory_order_release);
    return todo;
}

/* consumer side: read up to max complex samples */
size_t iq_ring_read(IqRing *r, float *out, size_t max)
{
    size_t used = ring_used(r);
    size_t todo = used <= max ? used : max;
    size_t t = atomic_load_explicit(&r->tail, memory_order_relaxed);
    for (size_t k = 0; k < todo;) {
        size_t pos = (t + k) % r->capacity;
        size_t run = r->capacity - pos;
        if (run > todo - k) run = todo - k;
        memcpy(out + 2 * k, r->data + 2 * pos, sizeof(float) * 2 * run);
        k += run;
    }
    atomic_store_explicit(&r->tail, t + todo, memory_order_release);
    if (ring_used(r) < r->reset_threshold)
        atomic_store_explicit(&r->overflow, 0, memory_order_relaxed);
    return todo;
}

/* ---- sample format converters (USB tuner native-format analogs) ---- */

/* RTL2832: unsigned 8-bit I/Q, zero at 127.5 */
void convert_u8_iq(const uint8_t *in, float *out, size_t n_values)
{
    const float scale = 1.0f / 127.5f;
    for (size_t i = 0; i < n_values; i++)
        out[i] = ((float)in[i] - 127.5f) * scale;
}

/* 16-bit signed I/Q (HackRF/SDRplay style) */
void convert_s16_iq(const int16_t *in, float *out, size_t n_values)
{
    const float scale = 1.0f / 32768.0f;
    for (size_t i = 0; i < n_values; i++)
        out[i] = (float)in[i] * scale;
}

/* Airspy packed 12-bit: 2 samples per 3 bytes, unsigned with 2048 offset */
void convert_packed12_iq(const uint8_t *in, float *out, size_t n_values)
{
    const float scale = 1.0f / 2048.0f;
    size_t o = 0;
    for (size_t i = 0; o + 1 < n_values; i += 3, o += 2) {
        uint16_t a = (uint16_t)((in[i] << 4) | (in[i + 1] >> 4));
        uint16_t b = (uint16_t)(((in[i + 1] & 0x0F) << 8) | in[i + 2]);
        out[o] = ((float)a - 2048.0f) * scale;
        out[o + 1] = ((float)b - 2048.0f) * scale;
    }
}
