"""Bytes and operations that a call must move and compute, worked out from
the shapes of its inputs and outputs, and the card's peaks."""
