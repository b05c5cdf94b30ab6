"""Models of the port: the GNNs (``models.gnn``) and the LM pool's decoder
(``models.transformer``, imported from there)."""
