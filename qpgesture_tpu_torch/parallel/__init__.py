"""Multi-process paths: torch.distributed process groups in place of the JAX
package's device mesh (``dist``), and the database-sharded candidate search
(``sharded_match``)."""
