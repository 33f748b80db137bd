"""``host_launches_per_replay``: the host's CUDA launch calls (kernels,
copies, sets, graphs) in the profiled slice from its first
``cudaGraphLaunch`` on, over the number of graph launches: what a fused
region's replay costs the host beside the graph itself."""


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    graphs = [t for t, name in sl.host_calls if name == "cudaGraphLaunch"]
    if not graphs:
        return None
    return sum(1 for t, _ in sl.host_calls if t >= graphs[0]) / len(graphs)
