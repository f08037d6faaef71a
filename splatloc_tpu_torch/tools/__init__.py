"""Reference-scale programs of the port: the full-scale quality gate
(``quality_gate``) and the refinement basin table (``refine_table``), each
the counterpart of the repo's tool of the same name."""
