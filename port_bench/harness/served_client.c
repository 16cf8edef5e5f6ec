/* The served cell's load generator: emulator clients of the frame server,
 * one thread each, sending at a fixed rate in an open schedule.
 *
 * The wire protocol v1 of the frame server (runtime/sidecar.py), as the
 * emulator's client (runtime/sidecar_client.c) speaks it: a 16-byte
 * handshake from the server ("FSE1", version 1, depth, height, width,
 * channels 4), then 0x01 + H*W*4 bytes a frame from the client and 0x81 +
 * H*W*4 bytes an enhanced frame from the server.
 *
 *     served_client <socket>
 *
 * Standard input: one line
 *     clients C frames F bytes B period_ns P window_ns W warmup K timeout_s T samples S
 * followed on the same line by C phases in ns and S pairs "client seq" (the
 * replies to keep), then C*F*B bytes: client c's recording is frames
 * [c*F, (c+1)*F). Each client connects, sends K warm-up frames in a closed
 * loop, and waits for the others. Then frame `seq` of client c is due at
 * T0 + phase[c] + seq*P for every due time before T0 + W; the client sleeps
 * until it is due, sends it, and reads its reply (depth 0) before it turns
 * to the next one, so a late reply makes the next frames late too, and
 * their latency counts from their due time. A reply that does not come
 * within T seconds fails that frame and every later one of that client.
 *
 * Standard output: "T0 <ns>" as soon as the schedule starts
 * (CLOCK_MONOTONIC), then "done <records> <samples>", one line
 * "<client> <seq> <due_ns> <send_ns> <recv_ns> <ok>" a frame, and for each
 * kept reply a line "frame <client> <seq> <ok>" followed by its B bytes.
 */
#define _GNU_SOURCE
#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

#define OP_FRAME 0x01
#define RE_FRAME 0x81

typedef struct {
    int64_t due, send, recv;
    int ok;
} record_t;

typedef struct {
    int client, seq, ok;
    uint8_t *bytes;
} sample_t;

static const char *g_socket;
static int g_clients, g_frames, g_warmup, g_timeout_s, g_samples;
static size_t g_bytes;
static int64_t g_period, g_window, g_t0;
static int64_t *g_phase;
static uint8_t *g_recording;
static record_t **g_records;
static int *g_count;
static sample_t *g_sample;
static pthread_barrier_t g_ready, g_go;

static int64_t now_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static void sleep_until(int64_t t) {
    struct timespec ts = {(time_t)(t / 1000000000LL), (long)(t % 1000000000LL)};
    while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, NULL) == EINTR) {
    }
}

static int read_exact(int fd, void *buf, size_t n) {
    uint8_t *p = (uint8_t *)buf;
    while (n > 0) {
        ssize_t r = read(fd, p, n);
        if (r <= 0) return -1;
        p += r;
        n -= (size_t)r;
    }
    return 0;
}

static int send_all(int fd, const void *buf, size_t n) {
    const uint8_t *p = (const uint8_t *)buf;
    while (n > 0) {
        ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
        if (r <= 0) return -1;
        p += r;
        n -= (size_t)r;
    }
    return 0;
}

static int connect_server(void) {
    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    struct sockaddr_un addr;
    memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, g_socket, sizeof(addr.sun_path) - 1);
    struct timeval tv = {g_timeout_s, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    uint8_t hs[16];
    if (connect(fd, (struct sockaddr *)&addr, sizeof(addr)) != 0 || read_exact(fd, hs, 16) != 0 ||
        memcmp(hs, "FSE1", 4) != 0 || hs[4] != 1 || hs[10] != 4 ||
        (size_t)(hs[6] | hs[7] << 8) * (size_t)(hs[8] | hs[9] << 8) * 4 != g_bytes) {
        close(fd);
        return -1;
    }
    return fd;
}

/* Send one frame and read its reply into buf; 0 on success. */
static int exchange(int fd, const uint8_t *frame, uint8_t *buf) {
    uint8_t op = OP_FRAME, tag = 0;
    if (send_all(fd, &op, 1) != 0 || send_all(fd, frame, g_bytes) != 0) return -1;
    if (read_exact(fd, &tag, 1) != 0 || tag != RE_FRAME) return -1;
    return read_exact(fd, buf, g_bytes);
}

static int n_due(int c) {
    int64_t span = g_window - g_phase[c];
    return span <= 0 ? 0 : (int)((span + g_period - 1) / g_period);
}

static void *client_main(void *arg) {
    int c = (int)(intptr_t)arg;
    const uint8_t *rec = g_recording + (size_t)c * g_frames * g_bytes;
    uint8_t *buf = malloc(g_bytes);
    int fd = connect_server();
    int alive = fd >= 0 && buf != NULL;
    for (int i = 0; alive && i < g_warmup; ++i)
        alive = exchange(fd, rec + (size_t)(i % g_frames) * g_bytes, buf) == 0;
    pthread_barrier_wait(&g_ready);
    if (c == 0) {
        g_t0 = now_ns() + 20000000LL;
        printf("T0 %lld\n", (long long)g_t0);
        fflush(stdout);
    }
    pthread_barrier_wait(&g_go);
    int n = n_due(c);
    for (int seq = 0; seq < n; ++seq) {
        record_t *r = &g_records[c][seq];
        r->due = g_t0 + g_phase[c] + (int64_t)seq * g_period;
        r->ok = 0;
        if (!alive) continue;
        sleep_until(r->due);
        r->send = now_ns();
        alive = exchange(fd, rec + (size_t)(seq % g_frames) * g_bytes, buf) == 0;
        r->recv = now_ns();
        r->ok = alive;
        for (int s = 0; s < g_samples; ++s)
            if (g_sample[s].client == c && g_sample[s].seq == seq) {
                memcpy(g_sample[s].bytes, buf, g_bytes);
                g_sample[s].ok = alive;
            }
    }
    g_count[c] = n;
    if (fd >= 0) close(fd);
    free(buf);
    return NULL;
}

int main(int argc, char **argv) {
    if (argc != 2) {
        fprintf(stderr, "usage: served_client <socket> < schedule-and-frames\n");
        return 2;
    }
    g_socket = argv[1];
    long long period, window;
    if (scanf(" clients %d frames %d bytes %zu period_ns %lld window_ns %lld warmup %d "
              "timeout_s %d samples %d",
              &g_clients, &g_frames, &g_bytes, &period, &window, &g_warmup, &g_timeout_s,
              &g_samples) != 8 || g_clients < 1 || g_frames < 1 || g_samples < 0) {
        fprintf(stderr, "served_client: bad header\n");
        return 2;
    }
    g_period = period;
    g_window = window;
    g_phase = calloc(g_clients, sizeof(int64_t));
    g_sample = calloc(g_samples > 0 ? g_samples : 1, sizeof(sample_t));
    for (int c = 0; c < g_clients; ++c) {
        long long p;
        if (scanf(" %lld", &p) != 1) return 2;
        g_phase[c] = p;
    }
    for (int s = 0; s < g_samples; ++s) {
        if (scanf(" %d %d", &g_sample[s].client, &g_sample[s].seq) != 2) return 2;
        g_sample[s].bytes = calloc(1, g_bytes);
    }
    if (getchar() != '\n') return 2;
    size_t total = (size_t)g_clients * g_frames * g_bytes;
    g_recording = malloc(total);
    if (g_recording == NULL || fread(g_recording, 1, total, stdin) != total) {
        fprintf(stderr, "served_client: short recording\n");
        return 2;
    }
    g_records = calloc(g_clients, sizeof(record_t *));
    g_count = calloc(g_clients, sizeof(int));
    for (int c = 0; c < g_clients; ++c) g_records[c] = calloc(n_due(c) + 1, sizeof(record_t));
    pthread_barrier_init(&g_ready, NULL, (unsigned)g_clients);
    pthread_barrier_init(&g_go, NULL, (unsigned)g_clients);
    pthread_t *threads = calloc(g_clients, sizeof(pthread_t));
    for (int c = 0; c < g_clients; ++c)
        pthread_create(&threads[c], NULL, client_main, (void *)(intptr_t)c);
    for (int c = 0; c < g_clients; ++c) pthread_join(threads[c], NULL);
    int records = 0;
    for (int c = 0; c < g_clients; ++c) records += g_count[c];
    printf("done %d %d\n", records, g_samples);
    for (int c = 0; c < g_clients; ++c)
        for (int i = 0; i < g_count[c]; ++i) {
            record_t *r = &g_records[c][i];
            printf("%d %d %lld %lld %lld %d\n", c, i, (long long)r->due, (long long)r->send,
                   (long long)r->recv, r->ok);
        }
    for (int s = 0; s < g_samples; ++s) {
        printf("frame %d %d %d\n", g_sample[s].client, g_sample[s].seq, g_sample[s].ok);
        fwrite(g_sample[s].bytes, 1, g_bytes, stdout);
    }
    fflush(stdout);
    return 0;
}
