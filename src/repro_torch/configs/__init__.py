"""The architecture configs the port runs: the four dense models, the two
MoE models, mamba2 and the jamba hybrid (copies of ``repro/configs``)."""
