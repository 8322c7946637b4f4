"""coco-caption-compatible metrics: the port's own copies of the JAX
package's pure-Python ``metrics/`` modules (BLEU, ROUGE-L, CIDEr, CIDEr-D,
METEOR and SPICE), so that the port needs nothing of the JAX package.  The
one change: without ``nltk`` the in-process METEOR runs without its stem
stage (``METEOR_backend`` then reads ``native[exact]``) instead of
failing."""
