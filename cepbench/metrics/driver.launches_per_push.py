"""driver.launches_per_push: the program's own kernel launch counter
(``repro_torch.kernels.ops.launch_counts``, every kernel) over the
traced window, divided by the window's pushes."""


def read(tr):
    pushes = tr.counts.get("pushes", 0)
    if not pushes or "launches" not in tr.counts:
        return None
    return tr.counts["launches"] / pushes
