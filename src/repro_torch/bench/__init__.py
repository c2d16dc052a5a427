"""Bench scripts of the port (``python -m repro_torch.bench.<name>``): the
paper's Table-2 engine matrix (``table2_bfs``), the dense multi-source
baseline against the BVSS engine (``bench_service``) and the kernel bench
(``kernel_bench``).  They run on the card unless given ``device="cpu"``."""
