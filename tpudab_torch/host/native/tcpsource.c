/* rtl_tcp client: network IQ source feeding the SPSC ring.
 *
 * Live-SDR ingest parity with the reference plugin's VFO sample stream
 * (the reference's src/dab_module.cpp:139-150 attaches a 2.048 MHz VFO and
 * the OFDM thread consumes it): here the sample transport is the public
 * rtl_tcp protocol — on connect the server sends a 12-byte header
 * ("RTL0" + tuner type u32be + gain count u32be) and then streams raw
 * unsigned 8-bit interleaved IQ; the client controls it with 5-byte
 * commands (u8 cmd + u32be arg): 0x01 SET_FREQ, 0x02 SET_SAMPLE_RATE,
 * 0x03 SET_GAIN_MODE, 0x04 SET_GAIN, 0x05 SET_FREQ_CORRECTION.
 *
 * The reader thread converts u8 IQ -> interleaved complex float32 and
 * blocking-writes into the ring (backpressure: the socket naturally stalls
 * when the decode loop falls behind). dab_tcp_set_freq() retunes the
 * remote dongle mid-stream (the plugin's click-to-tune analog,
 * the reference's src/render_radio_block.cpp:490-752).
 */

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

/* from ringbuf.c */
typedef struct dab_ring dab_ring_t;
long dab_ring_write(void *r, const uint8_t *data, size_t n);
void dab_ring_close(void *r);

enum {
    RTLTCP_SET_FREQ = 0x01,
    RTLTCP_SET_SAMPLE_RATE = 0x02,
    RTLTCP_SET_GAIN_MODE = 0x03,
    RTLTCP_SET_AGC_MODE = 0x08,
};

typedef struct {
    void *ring;
    int fd;
    pthread_t thread;
    pthread_mutex_t mu; /* guards command writes to fd */
    int done;
    int stop;
    char magic[5];
    uint32_t tuner_type;
    uint32_t gain_count;
} dab_tcp_source_t;

static int send_cmd(dab_tcp_source_t *s, uint8_t cmd, uint32_t arg) {
    uint8_t pkt[5];
    pkt[0] = cmd;
    uint32_t be = htonl(arg);
    memcpy(pkt + 1, &be, 4);
    pthread_mutex_lock(&s->mu);
    ssize_t w = send(s->fd, pkt, 5, MSG_NOSIGNAL);
    pthread_mutex_unlock(&s->mu);
    return w == 5 ? 0 : -1;
}

static int read_full(int fd, uint8_t *buf, size_t n) {
    size_t done = 0;
    while (done < n) {
        ssize_t got = recv(fd, buf + done, n - done, 0);
        if (got <= 0) return -1;
        done += (size_t)got;
    }
    return 0;
}

static void *tcp_source_main(void *arg) {
    dab_tcp_source_t *s = arg;
    enum { CHUNK = 65536 };
    uint8_t *in = malloc(CHUNK);
    float *out = malloc(CHUNK * sizeof(float));
    while (!s->stop) {
        ssize_t n = recv(s->fd, in, CHUNK, 0);
        if (n <= 0) break;
        for (ssize_t i = 0; i < n; i++)
            out[i] = ((float)in[i] - 127.5f) / 128.0f;
        if (dab_ring_write(s->ring, (uint8_t *)out, (size_t)n * 4) <
            (long)((size_t)n * 4))
            break;
    }
    dab_ring_close(s->ring);
    s->done = 1;
    free(in);
    free(out);
    return NULL;
}

/* Connect, validate the header, configure sample rate + initial frequency,
 * start the reader thread. Returns NULL on any failure. */
dab_tcp_source_t *dab_tcp_source_start(const char *host, int port,
                                       void *ring, uint32_t sample_rate,
                                       uint32_t freq_hz) {
    dab_tcp_source_t *s = calloc(1, sizeof(dab_tcp_source_t));
    if (!s) return NULL;
    s->ring = ring;
    s->fd = -1;
    pthread_mutex_init(&s->mu, NULL);

    char portstr[16];
    snprintf(portstr, sizeof portstr, "%d", port);
    struct addrinfo hints, *res = NULL;
    memset(&hints, 0, sizeof hints);
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(host, portstr, &hints, &res) != 0) goto fail;
    s->fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (s->fd < 0) { freeaddrinfo(res); goto fail; }
    if (connect(s->fd, res->ai_addr, res->ai_addrlen) != 0) {
        freeaddrinfo(res);
        goto fail;
    }
    freeaddrinfo(res);
    int one = 1;
    setsockopt(s->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);

    uint8_t hdr[12];
    if (read_full(s->fd, hdr, 12) != 0) goto fail;
    memcpy(s->magic, hdr, 4);
    s->magic[4] = 0;
    if (memcmp(hdr, "RTL0", 4) != 0) goto fail;
    uint32_t tt, gc;
    memcpy(&tt, hdr + 4, 4);
    memcpy(&gc, hdr + 8, 4);
    s->tuner_type = ntohl(tt);
    s->gain_count = ntohl(gc);

    if (send_cmd(s, RTLTCP_SET_SAMPLE_RATE, sample_rate) != 0) goto fail;
    if (freq_hz && send_cmd(s, RTLTCP_SET_FREQ, freq_hz) != 0) goto fail;
    /* AGC on (gain mode auto): sane default for a headless receiver */
    send_cmd(s, RTLTCP_SET_GAIN_MODE, 0);

    pthread_create(&s->thread, NULL, tcp_source_main, s);
    return s;
fail:
    if (s->fd >= 0) close(s->fd);
    pthread_mutex_destroy(&s->mu);
    free(s);
    return NULL;
}

int dab_tcp_set_freq(dab_tcp_source_t *s, uint32_t freq_hz) {
    return send_cmd(s, RTLTCP_SET_FREQ, freq_hz);
}

int dab_tcp_source_done(dab_tcp_source_t *s) { return s->done; }
uint32_t dab_tcp_tuner_type(dab_tcp_source_t *s) { return s->tuner_type; }

void dab_tcp_source_stop(dab_tcp_source_t *s) {
    s->stop = 1;
    /* Unblock BOTH places the reader thread can sit: a recv on the socket
     * AND a dab_ring_write on a full ring (when the consumer has stopped
     * draining, e.g. the radio loop is tearing down). Joining with only
     * the socket shut down deadlocks in that second case. */
    dab_ring_close(s->ring);
    shutdown(s->fd, SHUT_RDWR);
    pthread_join(s->thread, NULL);
    close(s->fd);
    pthread_mutex_destroy(&s->mu);
    free(s);
}
