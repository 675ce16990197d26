"""Nonce windows swept (``post_prove_windows_total``) in the window per
proof that returned in it."""

from benchmark.stats import counter_delta


def read(run):
    done = sum(1 for r in run.proofs if r.proof is not None and r.done
               and run.t0 <= r.done < run.t1)
    d = counter_delta(run, "post_prove_windows_total")
    if d is None or done == 0:
        return None
    return d / done
