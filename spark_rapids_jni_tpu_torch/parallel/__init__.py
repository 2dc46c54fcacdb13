"""Spark-exact partition ids, the local regroup of an exchange, the
out-of-range pid routing and the one-card shard mesh."""
