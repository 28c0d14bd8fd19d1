"""``torch.cuda.max_memory_allocated()`` over the window, in GiB: weights,
gradients, AdamW state and activations."""


def read(run):
    return None if run.window is None else run.window.peak_bytes / 2 ** 30
