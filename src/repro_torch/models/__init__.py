"""Model configuration shared by the planner and the kernels (``config``,
torch-free: search workers import it) and the model stack on torch
(``layers``, ``ssm``, ``rglru``, ``lm``, ``weights``)."""
