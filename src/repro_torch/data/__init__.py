"""Dataset generators and the token pipeline (port of ``repro/data``)."""
