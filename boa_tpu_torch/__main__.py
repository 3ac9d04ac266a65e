from boa_tpu_torch.cli import run

if __name__ == "__main__":
    run()
