"""99th percentile of the host ms of every call of the window."""

from mpcbench.harness import percentile


def read(ctx, arg):
    if not ctx.host_ms:
        return None
    print(f"# solve_p99_ms over {len(ctx.host_ms)} calls, "
          f"{len(ctx.host_ms) // 100} beyond it", flush=True)
    return percentile(ctx.host_ms, 99)
