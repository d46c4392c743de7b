"""peak_mem_gb: torch.cuda.max_memory_allocated() over set-up and window
(reset at the start of the run), in GB of 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9
