"""Problems solved over the whole window: calls completed x batch, over
the seconds from the first call's start to the last call's end."""


def read(ctx, arg):
    if not ctx.host_ms or ctx.window_s <= 0:
        return None
    return len(ctx.host_ms) * ctx.batch / ctx.window_s
