"""Host side of a job: the mean over the window's jobs of the host's time
around the compiled run, the job's state made and injected and its results
read back (the harness's own spans on the host clock)."""


def read(ctx):
    if ctx.traffic["loop"] == "intervals" or not ctx.units:
        return None
    return 1e3 * sum(u.host_s for u in ctx.units) / len(ctx.units)
