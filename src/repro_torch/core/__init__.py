"""Core of the port: op types, the paper's networks, the planning half
(the simulated phones in simulator/, the sync cost model in sync.py, the
GBDT latency predictors in predictor/, partitioner.py and planner.py) and
two-group channel-split co-execution on torch devices and streams
(coexec.py), and the trip-counted loop the cost walk collapses
(loops.py)."""
