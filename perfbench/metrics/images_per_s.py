"""Images whose logits reached the host in the window, over the window: from
the first call's issue to the arrival of the last call's logits."""


def read(run):
    return run.images / run.window_s
