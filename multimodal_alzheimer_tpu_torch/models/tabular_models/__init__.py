"""Tabular models: the standardising MLP, TabPFN and the decision tree."""
