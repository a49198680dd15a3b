/* Blocking SPSC byte ring buffer for the host streaming pipeline.
 *
 * Native-runtime parity with the reference's ThreadedRingBuffer<T>
 * (app_helpers/app_io_buffers.h, proven API at
 * the reference's src/radio_block.cpp:23-28,36-37,53): blocking write/read,
 * close() unblocks both sides for shutdown. Used from Python via ctypes
 * (ctypes foreign calls release the GIL, so reads/writes block natively).
 */

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    uint8_t *buf;
    size_t cap;
    size_t head;  /* write position */
    size_t tail;  /* read position */
    size_t fill;
    int closed;
    pthread_mutex_t mu;
    pthread_cond_t can_read;
    pthread_cond_t can_write;
} dab_ring_t;

dab_ring_t *dab_ring_create(size_t capacity) {
    dab_ring_t *r = calloc(1, sizeof(dab_ring_t));
    if (!r) return NULL;
    r->buf = malloc(capacity);
    if (!r->buf) { free(r); return NULL; }
    r->cap = capacity;
    pthread_mutex_init(&r->mu, NULL);
    pthread_cond_init(&r->can_read, NULL);
    pthread_cond_init(&r->can_write, NULL);
    return r;
}

/* Blocking write of n bytes; returns n, or bytes written before close. */
long dab_ring_write(dab_ring_t *r, const uint8_t *data, size_t n) {
    size_t done = 0;
    pthread_mutex_lock(&r->mu);
    while (done < n) {
        while (r->fill == r->cap && !r->closed)
            pthread_cond_wait(&r->can_write, &r->mu);
        if (r->closed) break;
        size_t space = r->cap - r->fill;
        size_t chunk = n - done < space ? n - done : space;
        size_t first = r->cap - r->head < chunk ? r->cap - r->head : chunk;
        memcpy(r->buf + r->head, data + done, first);
        memcpy(r->buf, data + done + first, chunk - first);
        r->head = (r->head + chunk) % r->cap;
        r->fill += chunk;
        done += chunk;
        pthread_cond_broadcast(&r->can_read);
    }
    pthread_mutex_unlock(&r->mu);
    return (long)done;
}

/* Blocking read of exactly n bytes; returns bytes read (< n only on close). */
long dab_ring_read(dab_ring_t *r, uint8_t *out, size_t n) {
    size_t done = 0;
    pthread_mutex_lock(&r->mu);
    while (done < n) {
        while (r->fill == 0 && !r->closed)
            pthread_cond_wait(&r->can_read, &r->mu);
        if (r->fill == 0 && r->closed) break;
        size_t chunk = n - done < r->fill ? n - done : r->fill;
        size_t first = r->cap - r->tail < chunk ? r->cap - r->tail : chunk;
        memcpy(out + done, r->buf + r->tail, first);
        memcpy(out + done + first, r->buf, chunk - first);
        r->tail = (r->tail + chunk) % r->cap;
        r->fill -= chunk;
        done += chunk;
        pthread_cond_broadcast(&r->can_write);
    }
    pthread_mutex_unlock(&r->mu);
    return (long)done;
}

size_t dab_ring_fill(dab_ring_t *r) {
    pthread_mutex_lock(&r->mu);
    size_t f = r->fill;
    pthread_mutex_unlock(&r->mu);
    return f;
}

void dab_ring_close(dab_ring_t *r) {
    pthread_mutex_lock(&r->mu);
    r->closed = 1;
    pthread_cond_broadcast(&r->can_read);
    pthread_cond_broadcast(&r->can_write);
    pthread_mutex_unlock(&r->mu);
}

void dab_ring_destroy(dab_ring_t *r) {
    if (!r) return;
    free(r->buf);
    pthread_mutex_destroy(&r->mu);
    pthread_cond_destroy(&r->can_read);
    pthread_cond_destroy(&r->can_write);
    free(r);
}

/* ---------------- IQ reader thread ----------------
 * Reads raw IQ from a file (or "-" for stdin) in a given sample format,
 * converts to interleaved complex float32, writes into a ring.
 * Formats: 0 = u8 (offset 127.5), 1 = s8, 2 = s16le, 3 = f32le.
 */

#include <stdio.h>

typedef struct {
    dab_ring_t *ring;
    FILE *fp;
    int format;
    int own_fp;
    pthread_t thread;
    int done;
} dab_iq_reader_t;

static void *iq_reader_main(void *arg) {
    dab_iq_reader_t *rd = arg;
    enum { CHUNK = 65536 };
    uint8_t *in = malloc(CHUNK);
    float *out = malloc(CHUNK * sizeof(float));
    size_t in_elem = rd->format == 2 ? 2 : (rd->format == 3 ? 4 : 1);
    for (;;) {
        size_t n = fread(in, in_elem, CHUNK / 4, rd->fp);
        if (n == 0) break;
        size_t nf = n;
        if (rd->format == 0) {
            for (size_t i = 0; i < nf; i++) out[i] = ((float)in[i] - 127.5f) / 128.0f;
        } else if (rd->format == 1) {
            for (size_t i = 0; i < nf; i++) out[i] = (float)(int8_t)in[i] / 128.0f;
        } else if (rd->format == 2) {
            const int16_t *s = (const int16_t *)in;
            for (size_t i = 0; i < nf; i++) out[i] = (float)s[i] / 32768.0f;
        } else {
            memcpy(out, in, nf * 4);
        }
        if (dab_ring_write(rd->ring, (uint8_t *)out, nf * 4) < (long)(nf * 4))
            break;
    }
    dab_ring_close(rd->ring);
    rd->done = 1;
    free(in);
    free(out);
    return NULL;
}

dab_iq_reader_t *dab_iq_reader_start(const char *path, int format,
                                     dab_ring_t *ring) {
    dab_iq_reader_t *rd = calloc(1, sizeof(dab_iq_reader_t));
    if (!rd) return NULL;
    if (path[0] == '-' && path[1] == 0) {
        rd->fp = stdin;
    } else {
        rd->fp = fopen(path, "rb");
        rd->own_fp = 1;
    }
    if (!rd->fp) { free(rd); return NULL; }
    rd->ring = ring;
    rd->format = format;
    pthread_create(&rd->thread, NULL, iq_reader_main, rd);
    return rd;
}

int dab_iq_reader_done(dab_iq_reader_t *rd) { return rd->done; }

void dab_iq_reader_join(dab_iq_reader_t *rd) {
    pthread_join(rd->thread, NULL);
    if (rd->own_fp) fclose(rd->fp);
    free(rd);
}
