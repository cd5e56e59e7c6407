"""Offline analysis: summaries of ``torch.profiler`` Chrome traces
(``trace``) and the halo exchange's traffic with the weak-scaling
projection (``comm``)."""
