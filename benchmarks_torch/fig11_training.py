"""Paper Fig. 11: training QPS upper bounds over the CC grid (reuses the
Fig. 8 sweep in training mode)."""
from benchmarks_torch import fig8_inference


def main():
    fig8_inference.main(mode="training")


if __name__ == "__main__":
    main()
