"""Command-line tools of the port (run with `python -m viso_tpu_torch.tools.<name>`)."""


def target(tool: str, device: str):
    """(torch.device, label) of a tool's run: the label is the card's name
    and power limit as nvidia-smi gives them, or "cpu". The card is the
    default; without one this raises unless the CPU is asked for."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{tool}: no CUDA device (pass --device cpu to run on the CPU)")
        from viso_tpu_torch.tools import bench_extract

        return dev, bench_extract.card_line()
    return dev, "cpu"
