"""Ported model families (vision: ResNet-9)."""
