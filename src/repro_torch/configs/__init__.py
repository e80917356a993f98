"""The dense architecture configs the port runs (copies of
``repro/configs``)."""
