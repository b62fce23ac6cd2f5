"""Ray-level renderers over a fused field+compositing callable, and the scene compositor."""
