"""Scenes of the examples, for the port."""
