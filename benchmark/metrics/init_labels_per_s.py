"""Labels written in the window, every initializing identity's, over the
whole window (host clock). The stored labels are sampled against the
reference in the same run."""


def read(run):
    if not any(i.role == "init" for i in run.identities) or run.window_s <= 0:
        return None
    return run.window_labels() / run.window_s
