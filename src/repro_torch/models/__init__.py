"""Models: the paper's 3-layer STIGMA CNN."""
