"""Model configuration shared by the planner and the kernels."""
