"""Training on the card: the ViT classification step and a minimal loop
(counterpart of the JAX package's ``train``)."""
