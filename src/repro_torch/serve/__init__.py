"""Batched query serving over the streaming monitor."""
