"""Both packages' clusters side by side for the tests that hold
presto_tpu_torch's ClusterRunner against presto_tpu's: each over its own
in-process workers (the port's on the CPU) at one scale factor."""
from presto_tpu.exec.cluster import ClusterRunner as JCluster
from presto_tpu.server.worker import WorkerServer as JWorker
from presto_tpu_torch.exec.cluster import ClusterRunner
from presto_tpu_torch.server.worker import WorkerServer
from torch_parity import assert_results_match


class Clusters:
    """``port`` and ``ref``: a ClusterRunner of each package over
    ``n_workers`` workers of its own; ``stop()`` ends them."""

    def __init__(self, sf: float, n_workers: int = 2):
        self.workers = [WorkerServer(tpch_sf=sf, device="cpu")
                        for _ in range(n_workers)]
        self.jworkers = [JWorker(tpch_sf=sf) for _ in range(n_workers)]
        for w in self.workers + self.jworkers:
            w.start()
        self.port = ClusterRunner(self.urls(self.workers), tpch_sf=sf,
                                  heartbeat=False, device="cpu")
        self.ref = JCluster(self.urls(self.jworkers), tpch_sf=sf,
                            heartbeat=False)

    @staticmethod
    def urls(workers):
        return [f"http://127.0.0.1:{w.port}" for w in workers]

    def check(self, sql: str, properties=None, rel: float = 1e-9):
        """The port's cluster rows equal the reference's: the same
        names, types and rows in the same order, integers exactly,
        doubles within ``rel``. Returns the port's result."""
        got = self.port.execute(sql, properties=properties)
        want = self.ref.execute(sql, properties=properties)
        assert_results_match(got, want, rel)
        return got

    def stop(self):
        for w in self.workers + self.jworkers:
            try:
                w.stop()
            except Exception:
                pass

