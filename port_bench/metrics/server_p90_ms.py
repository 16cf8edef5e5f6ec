"""The frame server's own p90 (enqueue to enhanced bytes in host memory,
the socket excluded), from the ``--stats`` file it writes at shutdown. It
counts every frame the server answered: the clients' warm-up frames too."""


def read(ctx):
    stats = ctx.get("server_stats")
    if not stats:
        return None
    return stats.get("p90_ms")
