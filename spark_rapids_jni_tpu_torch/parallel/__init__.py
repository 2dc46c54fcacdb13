"""Spark-exact partition ids and the local regroup of an exchange."""
