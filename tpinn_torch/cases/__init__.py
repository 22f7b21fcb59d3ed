"""Ported example cases."""
