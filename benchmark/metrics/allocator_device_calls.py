"""The CUDA caching allocator's cudaMalloc and cudaFree calls in the window:
the growth of ``device_allocator_calls{call=malloc}`` plus ``{call=free}``
between the registry's samples at its edges. A cudaFree waits for the whole
card, so in steady state this should read 0."""

CALLS = ((("call", "malloc"),), (("call", "free"),))


def read(run):
    try:
        before = run.registry["t0"]["device_allocator_calls"][1]
        after = run.registry["t1"]["device_allocator_calls"][1]
    except KeyError:
        return None
    if not any(k in after for k in CALLS):
        return None
    return sum(after.get(k, 0) - before.get(k, 0) for k in CALLS)
