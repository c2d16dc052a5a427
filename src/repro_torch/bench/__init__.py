"""Bench scripts of the port (``python -m repro_torch.bench.<name>``): the
paper's Table-2 engine matrix (``table2_bfs``), Tables 1a, 1b and 4
(``table1a_compression``, ``table1b_divergence``, ``table4_footprint``;
host statistics), Figure 3 (``fig3_window``), the RMAT scale sweep
(``bench_scale``), the analytics verbs against sequential baselines
(``bench_analytics``), wave serving against sequential BFS, the hardened
manager's overhead and the dense multi-source baseline against the BVSS
engine (``bench_service``), the async queue against call-at-a-time
serving (``bench_queue``) and the kernel bench (``kernel_bench``).  They
run on the card unless given ``device="cpu"``."""
